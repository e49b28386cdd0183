"""The Seeker slot for a batch of nodes, the intermittent lane, the lane
registry and the single-device fleet engine."""
from .edge_host import (  # noqa: F401
    SeekerNodeState, SensorStepOut, seeker_node_init,
    seeker_sensor_step_given_corr, seeker_host_step, seeker_simulate,
    IntermittentState, intermittent_node_init, intermittent_fleet_init,
    IntermittentLaneOut, intermittent_lane_step,
)
from .fleet import (  # noqa: F401
    fleet_node_init, draw_slot_noise, draw_fleet_noise, resolve_device,
    seeker_fleet_simulate, wire_bytes_exact,
)
from .fleet_lanes import (  # noqa: F401
    FLEET_LANES, FleetCarry, FleetLane, fleet_trace_keys,
)
