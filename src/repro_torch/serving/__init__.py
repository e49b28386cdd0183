"""The Seeker slot for a batch of nodes and the single-device fleet
engine."""
from .edge_host import (  # noqa: F401
    SeekerNodeState, SensorStepOut, seeker_node_init,
    seeker_sensor_step_given_corr, seeker_host_step, seeker_simulate,
)
from .fleet import (  # noqa: F401
    fleet_node_init, draw_slot_noise, draw_fleet_noise, resolve_device,
    seeker_fleet_simulate, wire_bytes_exact,
)
