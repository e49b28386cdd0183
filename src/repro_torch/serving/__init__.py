"""The Seeker slot for a batch of nodes, the intermittent lane, the lane
registry, the single-device fleet engine and its streamed driver."""
from .edge_host import (  # noqa: F401
    SeekerNodeState, SensorStepOut, seeker_node_init,
    seeker_sensor_step_given_corr, seeker_host_step, seeker_simulate,
    IntermittentState, intermittent_node_init, intermittent_fleet_init,
    IntermittentLaneOut, intermittent_lane_step,
)
from .fleet import (  # noqa: F401
    fleet_node_init, draw_slot_noise, draw_fleet_noise, resolve_device,
    fleet_telemetry_spec, seeker_fleet_simulate,
    seeker_fleet_simulate_streamed, wire_bytes_exact,
)
from .fleet_lanes import (  # noqa: F401
    FLEET_LANES, FleetCarry, FleetLane, TaskLaneConfig, fleet_counter_keys,
    fleet_lane, fleet_task_assignment, fleet_telemetry_lanes,
    fleet_trace_keys, stack_task_params,
)
