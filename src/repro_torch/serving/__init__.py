"""The Seeker slot for a batch of nodes, the per-sensor oracle, the
intermittent lane, the lane registry, the fleet engine (single-device and
node-sharded) and its streamed driver, the edge-to-host wire format, the
fleet's serve step and the pod-paired edge/host step; and the language
model's serving engine."""
from .engine import generate, greedy_sample, temperature_sample  # noqa: F401
from .edge_host import (  # noqa: F401
    SeekerNodeState, SensorStepOut, seeker_node_init, seeker_sensor_step,
    seeker_sensor_step_given_corr, seeker_host_step, seeker_simulate,
    seeker_simulate_reference,
    IntermittentState, intermittent_node_init, intermittent_fleet_init,
    IntermittentLaneOut, intermittent_lane_step, fleet_serve_step,
    edge_host_serve_step,
    WirePayload, encode_wire_coresets, decode_wire_coresets,
    wire_payload_nbytes, wire_payload_to_bytes, wire_payload_from_bytes,
    WireSamplePayload, encode_wire_samples, decode_wire_samples,
    wire_sample_nbytes,
)
from .fleet import (  # noqa: F401
    fleet_node_init, fleet_node_keys, draw_slot_noise,
    draw_slot_noise_keyed, draw_fleet_noise, resolve_device,
    fleet_graph_counts, fleet_telemetry_spec, seeker_fleet_simulate,
    seeker_fleet_simulate_sharded, seeker_fleet_simulate_streamed,
    wire_bytes_exact,
)
from .fleet_lanes import (  # noqa: F401
    FLEET_LANES, FleetCarry, FleetLane, TaskLaneConfig, fleet_counter_keys,
    fleet_lane, fleet_task_assignment, fleet_telemetry_lanes,
    fleet_trace_keys, stack_task_params,
)
