"""The host serving tier: QoS-deadline payload queue, EDF fixed-shape
microbatch scheduler, signature-keyed recovery cache, and the serve loop
(queue -> scheduler -> batched recovery -> DNN -> per-node ensemble).

PyTorch counterpart of :mod:`repro.host`."""
from .queue import (  # noqa: F401
    NO_DEADLINE, PayloadQueue, queue_init, queue_occupancy, queue_push,
    queue_push_batch, queue_wait_slots,
)
from .scheduler import (  # noqa: F401
    MicroBatch, batch_task_counts, batch_wait_slots, edf_pop_batch,
    expire_deadlines,
)
from .cache import (  # noqa: F401
    RecoveryCache, cache_init, cache_insert_batch, cache_lookup_batch,
    cache_stats, payload_signature,
)
from .server import (  # noqa: F401
    CLUSTER_KIND, SAMPLING_KIND, HostPayload, HostServeConfig,
    HostServerState, SlotOutput, cluster_entries, counter_noise,
    host_ensemble, host_payload_example, host_serve_slot, host_serve_trace,
    host_server_init, host_server_init_stacked, host_server_stats,
    host_telemetry_spec, recover_infer_batch, sampling_entries,
    serve_fleet_payloads, serve_graph_counts, serve_trace_count,
)
