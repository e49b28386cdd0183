"""repro_torch — the Seeker EH-WSN system in PyTorch, with hand-written CUDA
kernels for Hopper.

A second package beside the JAX reference ``repro``: the same modules, the
same array layouts at every public function, and tests that hold each
function against its JAX twin.  It imports neither JAX nor ``repro``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from .serving import (  # noqa: F401
    TaskLaneConfig, edge_host_serve_step, fleet_node_keys, fleet_serve_step,
    fleet_task_assignment, fleet_telemetry_spec, seeker_fleet_simulate,
    seeker_fleet_simulate_sharded, seeker_fleet_simulate_streamed,
    seeker_sensor_step, seeker_simulate, seeker_simulate_reference,
    stack_task_params,
)
