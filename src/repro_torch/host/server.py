"""The host serve loop: queue -> EDF scheduler -> batched recovery -> DNN.

PyTorch counterpart of :mod:`repro.host.server`.  Wire-format payloads from
the fleet are stamped with QoS deadlines and pushed into the
:mod:`repro_torch.host.queue` ring buffer; each serve slot the
:mod:`repro_torch.host.scheduler` assembles ``batches_per_slot`` fixed-shape
EDF microbatches; each batch is looked up in the recovery cache, recovered
(cluster-ball resynthesis or the generator, by entry kind) and run through
the full-precision HAR DNN; per-node results accumulate into a mean-logit
ensemble and a majority-vote histogram.  Each phase is a
:mod:`repro_torch.obs.trace` span: one ``host.batch`` a microbatch (the
first also ingests, the last also finishes the slot) holding
``host.ingest``, ``host.pop``, ``host.cache``, ``host.recover`` (the
recovery noise), ``host.dnn``, ``host.ensemble``, ``host.telemetry``
wherever the lanes move, and ``host.finish``.

What differs from the reference, and why:

* **Recovery noise is keyed by the payload, without ``jax.random``.** The
  reference keys each row's recovery by ``fold_in(fold_in(base_key,
  sig[0]), sig[1])``.  Here a ``noise_fn(sigs) -> {"dirs", "radii_u",
  "latent"}`` takes the (B, 2) signatures; the default
  (:func:`counter_noise`) hashes (``seed``, signature, element index) in
  integer tensor ops and maps the words to uniforms and, by Box-Muller, to
  normals.  Equal payloads recover equally on every call, so a cache hit is
  a recomputation.  Tests pass a ``noise_fn`` returning JAX's own draws.
* **No branch on a tensor value.** The reference skips recovery and the DNN
  for an all-hit batch (``lax.cond``) and recovers only the kinds a batch
  holds (``lax.switch``).  Here both recoveries and the DNN run for every
  batch, and each row selects what the reference's branch would have given
  it, invalid rows included; so a slot issues a fixed sequence of launches
  and reads nothing on the host (no synchronisation per batch or per
  slot).  The queue push of a slot is
  :func:`repro_torch.host.queue.push_lane`: its rows share one deadline,
  which makes even an overflowing push closed-form.
* **The ensemble scatter-add** (``index_add_``) is a float sum in index
  order on the CPU; on a CUDA device rows of one node in one batch are
  added in an unspecified order, so ``ensemble_logits`` may differ there
  in the last bits.  The vote histogram is int32 and exact.
* **Builds per shape are counted** with :mod:`repro_torch.obs.compile_guard`
  (``compile_event("host.serve", (cfg, tag))``) the first time the slot
  constants of a configuration and lane width are built, so
  :func:`serve_trace_count` keeps its meaning: distinct shapes built.
* **The carry** :class:`HostServerState` chains: calling
  :func:`host_serve_slot` slot by slot equals one :func:`host_serve_trace`
  of the same slots, bit for bit on the CPU.
* **On a CUDA device the slot is replayed as CUDA graphs.** The slot is a
  list of segments split at each call of a caller's ``noise_fn``, which
  runs eagerly between them, once a microbatch, on a ``sigs`` tensor it
  owns: segment 0 ingests and pops and looks up microbatch 0, segment
  ``i`` answers microbatch ``i - 1`` and opens microbatch ``i``, the last
  closes the slot (``batches_per_slot + 1`` graphs).  With
  ``noise_fn=None`` the default noise is tensor work, and the slot is one
  segment.  The first call of a key runs the segments eagerly on a side
  stream, then captures them; the key is (configuration, entry point,
  device, ``seed`` or a caller's ``noise_fn``, the inputs' shapes and
  dtypes, the address, shape, dtype and strides of every ``host_params``
  and ``gen_params`` tensor, the TF32 switches): new weight tensors mean
  a new capture, and an in-place update of the same tensors is read by
  the replay.  Eight keys are kept, each with its private memory pool.
  The inputs are copied into the graphs' buffers and the results handed
  out as clones, so every state and output the caller holds stays its
  own.  One driver (:func:`_drive`) runs the segments on every path, so
  eager runs and replays record the same ``host.batch`` and
  ``host.recover`` spans; the spans inside a segment record only when it
  runs eagerly, and a replay records ``host.ingest`` around its input
  copies and ``host.finish`` around its clones instead.
  :func:`serve_graph_counts` counts captures, replays and eagerly run
  segments; each capture is also a ``compile_event("host.serve_graph",
  (cfg, tag))``.  Elsewhere, and inside a capture of the caller's, the
  same segments run eagerly in order.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from ..core.coreset import ClusterCoreset, SamplingCoreset
from ..core.counter_hash import (box_muller, counter_words, fmix32,
                                 word_uniforms)
from ..core.recovery import (GeneratorParams, recover_cluster_window,
                             recover_sampling_window)
from ..graph_io import clone, copy_leaves, layout
from ..models.har import har_apply
from ..obs import trace as obs_trace
from ..obs import (MetricsSpec, counter, counter_add, gauge, gauge_set,
                   hist_observe, histogram, metrics_init, metrics_summary)
from ..obs.compile_guard import compile_event, compile_key_counts
from ..serving.edge_host import (WirePayload, WireSamplePayload,
                                 _check_coreset_fields, _check_sample_fields,
                                 _dequantize_coresets, _dequantize_samples,
                                 decode_wire_coresets)
from ..serving.fleet import resolve_device
from .cache import (RecoveryCache, batch_signatures, cache_init,
                    cache_insert_batch, cache_lookup_batch, cache_stats)
from .queue import (PayloadQueue, push_lane, queue_init, queue_occupancy,
                    queue_wait_slots, tree_map)
from .scheduler import MicroBatch, batch_wait_slots, edf_pop_batch

__all__ = ["HostServeConfig", "HostPayload", "HostServerState", "SlotOutput",
           "CLUSTER_KIND", "SAMPLING_KIND", "host_payload_example",
           "cluster_entries", "sampling_entries", "host_server_init",
           "host_server_init_stacked", "host_serve_slot",
           "host_serve_trace", "host_telemetry_spec", "serve_fleet_payloads",
           "recover_infer_batch", "host_server_stats", "host_ensemble",
           "serve_trace_count", "serve_graph_counts", "counter_noise",
           "LATENT"]

CLUSTER_KIND = 0    # D3 payload: quantized cluster coreset
SAMPLING_KIND = 1   # D4 payload: quantized importance samples + moments
LATENT = 16         # the generator's latent width (recovery.py:167)


@dataclasses.dataclass(frozen=True)
class HostServeConfig:
    """Static shape and QoS configuration of one host server (hashable: it
    keys the per-shape constants)."""

    channels: int               # sensor channels C
    k: int                      # clusters per channel (cluster payloads)
    m: int                      # samples per window (sampling payloads)
    t: int                      # window length the host recovers to
    n_classes: int
    n_nodes: int                # fleet size for the per-node ensemble
    batch_size: int = 64        # EDF microbatch rows (fixed shape)
    queue_capacity: int = 256   # ring-buffer slots (>= ingest width per slot)
    cache_capacity: int = 256   # recovery-memo entries
    qos_slots: int = 4          # deadline = arrival + qos_slots (inclusive)
    batches_per_slot: int = 1   # host service rate per slot
    telemetry: bool = False     # registry lanes + latency histograms in-slot
    n_tasks: int = 1            # mixed fleets: stacked per-task host DNNs

    def __post_init__(self):
        """Reject configurations that would silently corrupt service, with
        the reference's messages: a batch larger than the queue could never
        be filled."""
        for field in ("channels", "k", "m", "t", "n_classes", "n_nodes",
                      "batch_size", "queue_capacity", "cache_capacity",
                      "n_tasks"):
            v = getattr(self, field)
            if v < 1:
                raise ValueError(
                    f"HostServeConfig.{field} must be >= 1, got {v}")
        # qos_slots=0 is serve-this-slot-or-miss; batches_per_slot=0 is the
        # normalized probe key (serve_trace_count) — both legal
        for field in ("qos_slots", "batches_per_slot"):
            v = getattr(self, field)
            if v < 0:
                raise ValueError(
                    f"HostServeConfig.{field} must be >= 0, got {v}")
        if self.batch_size > self.queue_capacity:
            raise ValueError(
                f"HostServeConfig.batch_size={self.batch_size} exceeds "
                f"queue_capacity={self.queue_capacity}: edf_pop_batch can "
                f"only assemble queue_capacity rows, so the extra "
                f"{self.batch_size - self.queue_capacity} batch rows would "
                f"silently never be filled — raise queue_capacity or lower "
                f"batch_size")


class HostPayload(NamedTuple):
    """One queue entry's payload: the union of the two wire formats with a
    ``kind`` discriminator (the unused half is zeros) and the ``task`` whose
    host DNN answers it.  Leaves in the reference's order, which is the
    order :func:`repro_torch.host.cache.batch_signatures` hashes them in."""

    kind: torch.Tensor       # () int8 — CLUSTER_KIND | SAMPLING_KIND
    c_codes: torch.Tensor    # (C, k, 2) int16
    r_codes: torch.Tensor    # (C, k) int8
    n_codes: torch.Tensor    # (C, k) int8
    c_lo: torch.Tensor       # () float32
    c_hi: torch.Tensor       # () float32
    c_rhi: torch.Tensor      # () float32
    s_idx: torch.Tensor      # (m,) int8
    s_codes: torch.Tensor    # (m, C) int16
    s_lo: torch.Tensor       # () float32
    s_hi: torch.Tensor       # () float32
    s_mean: torch.Tensor     # (C,) float32
    s_var: torch.Tensor      # (C,) float32
    task: torch.Tensor       # () int8 — index into stacked per-task params


class SlotOutput(NamedTuple):
    """Per-slot served results: ``batches_per_slot * batch_size`` rows in
    EDF service order; padding rows have ``valid=False``."""

    node_id: torch.Tensor    # (Bq,) int32
    logits: torch.Tensor     # (Bq, L) float32
    deadline: torch.Tensor   # (Bq,) int32
    cache_hit: torch.Tensor  # (Bq,) bool
    valid: torch.Tensor      # (Bq,) bool


class HostServerState(NamedTuple):
    """The resumable serve-loop carry."""

    queue: PayloadQueue
    cache: RecoveryCache
    slot: torch.Tensor             # () int32 — host clock
    served: torch.Tensor           # () int32 — payloads answered in time
    deadline_misses: torch.Tensor  # () int32 — expired before service
    ensemble_logits: torch.Tensor  # (n_nodes, L) float32 — summed logits
    ensemble_votes: torch.Tensor   # (n_nodes, L) int32 — argmax histogram
    metrics: Any = None            # registry lanes when cfg.telemetry


def host_payload_example(cfg: HostServeConfig, device=None) -> HostPayload:
    """Zero entry defining the queue's slot shapes (``device=None`` means
    CUDA)."""
    dev = resolve_device(device)
    c, k, m = cfg.channels, cfg.k, cfg.m

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return HostPayload(
        kind=z((), torch.int8), c_codes=z((c, k, 2), torch.int16),
        r_codes=z((c, k), torch.int8), n_codes=z((c, k), torch.int8),
        c_lo=z(()), c_hi=z(()), c_rhi=z(()), s_idx=z((m,), torch.int8),
        s_codes=z((m, c), torch.int16), s_lo=z(()), s_hi=z(()),
        s_mean=z((c,)), s_var=z((c,)), task=z((), torch.int8))


def _entry_tasks(tasks, b: int, device) -> torch.Tensor:
    """(B,) int8 task column; ``None`` = task 0."""
    if tasks is None:
        return torch.zeros((b,), dtype=torch.int8, device=device)
    return torch.as_tensor(tasks, device=device).reshape(b).to(torch.int8)


def cluster_entries(wire: WirePayload, m: int,
                    tasks: torch.Tensor | None = None) -> HostPayload:
    """Batched D3 entries from a quantized cluster wire payload; ``tasks`` is
    the optional (B,) per-entry task id of a mixed fleet.  Reads no value:
    the payload was validated when it was encoded or parsed."""
    _check_coreset_fields(wire)
    b, c, _, _ = wire.c_codes.shape
    dev = wire.c_codes.device

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return HostPayload(
        kind=z((b,), torch.int8), c_codes=wire.c_codes,
        r_codes=wire.r_codes, n_codes=wire.n_codes,
        c_lo=wire.lo.reshape(b), c_hi=wire.hi.reshape(b),
        c_rhi=wire.rhi.reshape(b), s_idx=z((b, m), torch.int8),
        s_codes=z((b, m, c), torch.int16), s_lo=z((b,)), s_hi=z((b,)),
        s_mean=z((b, c)), s_var=z((b, c)), task=_entry_tasks(tasks, b, dev))


def sampling_entries(swire: WireSamplePayload, k: int,
                     tasks: torch.Tensor | None = None) -> HostPayload:
    """Batched D4 entries from a quantized sampling wire payload."""
    _check_sample_fields(swire)
    b, m = swire.idx.shape
    c = swire.v_codes.shape[-1]
    dev = swire.idx.device

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return HostPayload(
        kind=torch.full((b,), SAMPLING_KIND, dtype=torch.int8, device=dev),
        c_codes=z((b, c, k, 2), torch.int16), r_codes=z((b, c, k), torch.int8),
        n_codes=z((b, c, k), torch.int8), c_lo=z((b,)), c_hi=z((b,)),
        c_rhi=z((b,)), s_idx=swire.idx, s_codes=swire.v_codes,
        s_lo=swire.lo.reshape(b), s_hi=swire.hi.reshape(b),
        s_mean=swire.mean, s_var=swire.var,
        task=_entry_tasks(tasks, b, dev))


@functools.lru_cache(maxsize=32)
def _host_spec(qos_slots: int) -> MetricsSpec:
    # sojourn of a SERVED payload is 0..qos_slots; end-to-end latency is
    # sojourn + 1.  Small deadline windows get exact per-slot bins; large
    # ones 16 log-spaced bins over the feasible span.
    span = qos_slots + 1
    if span + 2 <= 18:
        lat = functools.partial(histogram, bins=span + 2, log=False,
                                unit="slots")
    else:
        lat = functools.partial(histogram, bins=16, lo=1.0, hi=float(span),
                                unit="slots")
    return MetricsSpec((
        counter("host.served", "payloads"),
        counter("host.deadline_misses", "payloads"),
        counter("host.drops_overflow", "payloads"),
        counter("host.cache_hits", "lookups"),
        counter("host.cache_misses", "lookups"),
        gauge("host.backlog", "payloads"),
        lat("host.sojourn_slots"),
        lat("host.e2e_slots"),
        lat("host.sojourn_slots.cluster"),
        lat("host.sojourn_slots.sampling"),
        lat("host.backlog_age_slots"),
    ))


def host_telemetry_spec(cfg: HostServeConfig) -> MetricsSpec:
    """The host tier's registry lanes: QoS counters, a backlog gauge, and
    the fixed-bin latency histograms (sojourn, end to end, per payload
    class, backlog age).  A function of ``cfg.qos_slots`` only."""
    return _host_spec(cfg.qos_slots)


def host_server_init(cfg: HostServeConfig, device=None) -> HostServerState:
    """An empty server on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return HostServerState(
        queue=queue_init(host_payload_example(cfg, dev), cfg.queue_capacity),
        cache=cache_init(cfg.cache_capacity, cfg.n_classes, dev),
        slot=z((), torch.int32), served=z((), torch.int32),
        deadline_misses=z((), torch.int32),
        ensemble_logits=z((cfg.n_nodes, cfg.n_classes), torch.float32),
        ensemble_votes=z((cfg.n_nodes, cfg.n_classes), torch.int32),
        metrics=(metrics_init(host_telemetry_spec(cfg), dev)
                 if cfg.telemetry else None))


def host_server_init_stacked(cfg: HostServeConfig, n_hosts: int,
                             device=None) -> HostServerState:
    """``n_hosts`` independent server states stacked on a leading axis (the
    reference's per-shard host carry; the port's per-shard mode waits for
    the sharded driver)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    one = host_server_init(cfg, device)

    def stack(a):
        return a[None].expand((n_hosts,) + tuple(a.shape)).clone()

    return tree_map(stack, one)


# ---------------------------------------------------------------------------
# Recovery noise keyed by the payload
# ---------------------------------------------------------------------------

def counter_noise(sigs: torch.Tensor, *, seed: int, channels: int,
                  t: int) -> dict:
    """The default recovery noise of (B, 2) payload signatures: a
    counter-based draw keyed by (``seed``, signature) in integer tensor ops,
    the same words on every call and every device (the floats by
    Box-Muller, to the device's last bit).  Element ``e`` of a row is the
    finalized hash of (row key, e); its top 24 bits give a uniform in
    (0, 1], exact in float32.  Returns ``dirs`` (B, C, T, 2) normals,
    ``radii_u`` (B, C, T, 1) uniforms in [0, 1) and ``latent`` (B, 16)
    normals, the shapes of ``repro/core/recovery.py``'s draws."""
    b = sigs.shape[0]
    n_dir, n_rad = channels * t * 2, channels * t
    n_norm = n_dir + LATENT
    key = fmix32(fmix32(sigs[:, 0] ^ ((seed & 0xFFFFFFFF) ^ 0x3C6EF372))
                 ^ sigs[:, 1])
    u = word_uniforms(counter_words(key, 2 * n_norm + n_rad))  # (0, 1]
    u1, u2, ur = u[:, :n_norm], u[:, n_norm:2 * n_norm], u[:, 2 * n_norm:]
    z = box_muller(u1, u2)
    return {"dirs": z[:, :n_dir].reshape(b, channels, t, 2),
            "radii_u": (1.0 - ur).reshape(b, channels, t, 1),
            "latent": z[:, n_dir:]}


# ---------------------------------------------------------------------------
# Batched recovery + inference (the host DNN path)
# ---------------------------------------------------------------------------

def recover_infer_batch(payload: WirePayload, host_params: dict,
                        noise: dict, t: int) -> torch.Tensor:
    """Decode a cluster wire-payload batch (validated), recover the windows
    with ``noise`` ``{"dirs": (B, C, T, 2), "radii_u": (B, C, T, 1)}``, and
    run the full-precision DNN -> (B, n_classes) logits."""
    centers, radii, counts = decode_wire_coresets(payload)
    wins = recover_cluster_window(ClusterCoreset(centers, radii, counts),
                                  noise["dirs"], noise["radii_u"], t)
    return har_apply(host_params, wins)


def _entry_windows(p: HostPayload, gen_params: GeneratorParams, noise: dict,
                   t: int, valid: torch.Tensor) -> torch.Tensor:
    """(B, T, C) windows of mixed-kind entries.  Both recoveries run for
    every row; each row takes the one the reference's kind switch gives it:
    a batch whose valid rows hold one kind (or none, which counts as
    cluster) recovers every row, padding included, as that kind; a mixed
    batch recovers each row as its own kind."""
    b = p.kind.shape[0]
    wire = WirePayload(p.c_codes, p.r_codes, p.n_codes,
                       p.c_lo.reshape(b, 1, 1, 1), p.c_hi.reshape(b, 1, 1, 1),
                       p.c_rhi.reshape(b, 1, 1))
    centers, radii, counts = _dequantize_coresets(wire)
    win_c = recover_cluster_window(ClusterCoreset(centers, radii, counts),
                                   noise["dirs"], noise["radii_u"], t)
    swire = WireSamplePayload(p.s_idx, p.s_codes, p.s_lo.reshape(b, 1, 1),
                              p.s_hi.reshape(b, 1, 1), p.s_mean, p.s_var)
    idx, vals, mean, var = _dequantize_samples(swire)
    win_s = recover_sampling_window(
        gen_params, SamplingCoreset(idx, vals, torch.ones_like(
            idx, dtype=torch.float32), mean, var), noise["latent"], t)
    is_c = p.kind == CLUSTER_KIND
    has_s = (valid & (p.kind == SAMPLING_KIND)).any()
    has_c = (valid & is_c).any()
    use_c = torch.where(has_s & has_c, is_c, ~has_s)
    return torch.where(use_c[:, None, None], win_c, win_s)


def _check_lane_width(cfg: HostServeConfig, width: int) -> None:
    """An ingest lane wider than the ring would overflow every slot."""
    if width > cfg.queue_capacity:
        raise ValueError(
            f"ingest lane of {width} entries exceeds queue_capacity="
            f"{cfg.queue_capacity}: even an empty queue would overflow on "
            f"every slot — raise HostServeConfig.queue_capacity or narrow "
            f"the lane")


# ---------------------------------------------------------------------------
# The serve slot
# ---------------------------------------------------------------------------

_SERVE_COMPONENT = "host.serve"
_GRAPH_COMPONENT = "host.serve_graph"


class _SlotConsts(NamedTuple):
    rows: torch.Tensor          # (batch_size,) int64 — row index
    classes: torch.Tensor       # (n_classes,) int64


# never evicted: a captured serve graph reads these tensors while it lives
@functools.lru_cache(maxsize=None)
def _slot_consts(cfg: HostServeConfig, tag: str, width: int,
                 device: torch.device) -> _SlotConsts:
    """The per-shape constants of a serve slot, built once per
    (configuration, entry point, lane width, device): each build is one
    ``compile_event``, the analogue of the reference's trace per shape."""
    compile_event(_SERVE_COMPONENT, (cfg, tag))
    return _SlotConsts(
        rows=torch.arange(cfg.batch_size, device=device),
        classes=torch.arange(cfg.n_classes, device=device))


def serve_trace_count(cfg: HostServeConfig | None = None) -> int:
    """How many serve shapes were built.  With ``cfg``, every build for that
    config including its service-rate variants (``batches_per_slot``);
    without, the global total."""
    counts = compile_key_counts(_SERVE_COMPONENT)
    if cfg is not None:
        key = dataclasses.replace(cfg, batches_per_slot=0)
        return sum(
            n for (c, _), n in counts.items()
            if dataclasses.replace(c, batches_per_slot=0) == key)
    return sum(counts.values())


def _host_dnn(cfg: HostServeConfig, host_params: dict, wins: torch.Tensor,
              task: torch.Tensor, consts: _SlotConsts) -> torch.Tensor:
    """Logits of the batch: one DNN, or with ``n_tasks > 1`` every task's
    DNN over the whole batch (``host_params`` stacked leaf-wise on a leading
    task axis) and each row's own task selected."""
    if cfg.n_tasks == 1:
        return har_apply(host_params, wins)
    per_task = torch.stack([
        har_apply({k: v[i] for k, v in host_params.items()}, wins)
        for i in range(cfg.n_tasks)])
    tid = torch.clamp(task.to(torch.int64), 0, cfg.n_tasks - 1)
    return per_task[tid, consts.rows]


class _Pending(NamedTuple):
    """A popped microbatch between its cache lookup and its recovery."""

    batch: MicroBatch
    missed: torch.Tensor     # () int32 — expired by this pop
    sigs: torch.Tensor       # (B, 2) int64 — what the recovery noise keys
    hit: torch.Tensor        # (B,) bool
    cached: torch.Tensor     # (B, L) float32 — the cache's logits


class _Carry(NamedTuple):
    """The serve slot between two of its segments."""

    queue: PayloadQueue
    cache: RecoveryCache
    now: torch.Tensor
    served: torch.Tensor
    missed: torch.Tensor
    ens_l: torch.Tensor
    ens_v: torch.Tensor
    metrics: Any
    outs: tuple              # a SlotOutput per answered microbatch
    pending: _Pending | None


def _ingest(cfg: HostServeConfig, state: HostServerState,
            entries: HostPayload, node_ids: torch.Tensor,
            mask: torch.Tensor) -> _Carry:
    """Push the slot's stamped arrivals; count the overflow drops."""
    metrics = state.metrics
    if cfg.telemetry and metrics is None:
        raise ValueError(
            "cfg.telemetry=True but the server state has no metrics lanes — "
            "build the state with host_server_init(cfg) using the SAME "
            "telemetry setting (the lanes are part of the resumable carry)")
    now = state.slot
    with obs_trace.span("host.ingest"):
        queue, _ = push_lane(state.queue, entries, node_ids, now,
                             now + cfg.qos_slots, mask)
    if cfg.telemetry:
        with obs_trace.span("host.telemetry"):
            metrics = counter_add(
                host_telemetry_spec(cfg), metrics, "host.drops_overflow",
                queue.drops_overflow - state.queue.drops_overflow)
    return _Carry(queue, state.cache, now, state.served,
                  state.deadline_misses, state.ensemble_logits,
                  state.ensemble_votes, metrics, (), None)


def _pop(cfg: HostServeConfig, c: _Carry) -> _Carry:
    """Pop the next EDF microbatch and look its rows up in the cache."""
    with obs_trace.span("host.pop"):
        queue, batch, missed = edf_pop_batch(c.queue, cfg.batch_size,
                                             now=c.now)
    with obs_trace.span("host.cache"):
        sigs = batch_signatures(batch.payload)                   # (B, 2)
        hit, cached = cache_lookup_batch(c.cache, sigs, batch.valid)
    return c._replace(queue=queue, missed=c.missed + missed,
                      pending=_Pending(batch, missed, sigs, hit, cached))


def _answer(cfg: HostServeConfig, consts: _SlotConsts, c: _Carry,
            noise: dict, host_params: dict,
            gen_params: GeneratorParams) -> _Carry:
    """Answer the pending microbatch: recovery with ``noise``, the DNN, the
    logits each row takes, the ensemble, the cache insert and the
    microbatch's telemetry."""
    batch, missed, sigs, hit, cached = c.pending
    valid = batch.valid
    wins = _entry_windows(batch.payload, gen_params, noise, cfg.t, valid)
    with obs_trace.span("host.dnn"):
        computed = _host_dnn(cfg, host_params, wins, batch.payload.task,
                             consts)
    with obs_trace.span("host.ensemble"):
        # an all-hit batch answers every row from the cache (the reference
        # skips recovery and the DNN for it); otherwise the hits do
        all_hit = (hit | ~valid).all()
        logits = torch.where(all_hit | hit[:, None], cached, computed)
        served = c.served + valid.sum().to(torch.int32)
        # per-node ensemble: mean-logit sum + majority-vote histogram
        nid = torch.clamp(torch.where(valid, batch.node_id, 0), 0,
                          cfg.n_nodes - 1).to(torch.int64)
        w = valid.to(torch.float32)[:, None]
        ens_l = c.ens_l.index_add(0, nid, logits * w)
        votes = ((torch.argmax(logits, dim=-1)[:, None]
                  == consts.classes) & valid[:, None]).to(torch.int32)
        ens_v = c.ens_v.index_add(0, nid, votes)
        out = SlotOutput(batch.node_id, logits, batch.deadline, hit, valid)
    with obs_trace.span("host.cache"):
        fresh = valid & ~hit
        cache = cache_insert_batch(c.cache, sigs, logits, fresh)
        cache = cache._replace(
            hits=cache.hits + hit.sum().to(torch.int32),
            misses=cache.misses + fresh.sum().to(torch.int32))
    metrics = c.metrics
    if cfg.telemetry:
        with obs_trace.span("host.telemetry"):
            metrics = _batch_telemetry(host_telemetry_spec(cfg), metrics,
                                       batch, c.now, missed, hit, fresh)
    return c._replace(cache=cache, served=served, ens_l=ens_l, ens_v=ens_v,
                      metrics=metrics, outs=c.outs + (out,), pending=None)


def _close(cfg: HostServeConfig, c: _Carry
           ) -> tuple[HostServerState, SlotOutput]:
    """The backlog's telemetry, then the slot's rows and the new state."""
    metrics = c.metrics
    if cfg.telemetry:
        tel = host_telemetry_spec(cfg)
        with obs_trace.span("host.telemetry"):
            metrics = gauge_set(tel, metrics, "host.backlog",
                                queue_occupancy(c.queue))
            metrics = hist_observe(tel, metrics, "host.backlog_age_slots",
                                   queue_wait_slots(c.queue, c.now),
                                   c.queue.valid)
    with obs_trace.span("host.finish"):
        out = SlotOutput(*(torch.cat(xs, dim=0) for xs in zip(*c.outs)))
        state = HostServerState(c.queue, c.cache, (c.now + 1).to(torch.int32),
                                c.served, c.missed, c.ens_l, c.ens_v, metrics)
    return state, out


def _segments(cfg: HostServeConfig, consts: _SlotConsts, host_params: dict,
              gen_params: GeneratorParams) -> list:
    """The serve slot as ``batches_per_slot + 1`` segment functions, split
    where a microbatch's recovery noise is drawn.  The first takes
    ``(state, entries, node_ids, mask)``, ingests and opens microbatch 0
    (pop, signatures, lookup); segment ``i`` takes ``(carry, noise)``,
    answers microbatch ``i - 1`` and opens microbatch ``i``; the last
    closes the slot instead and returns ``(state', SlotOutput)``.  A
    carry's ``pending.sigs`` is what the next noise is drawn from."""
    n = cfg.batches_per_slot

    def first(state, entries, node_ids, mask):
        return _pop(cfg, _ingest(cfg, state, entries, node_ids, mask))

    def answer(c, noise, last):
        c = _answer(cfg, consts, c, noise, host_params, gen_params)
        return _close(cfg, c) if last else _pop(cfg, c)

    return [first] + [functools.partial(answer, last=bi == n - 1)
                      for bi in range(n)]


def _drive(step: Callable, n: int, noise_fn: Callable | None) -> None:
    """Run a slot's segments in order: ``step(j, noise)`` runs segment
    ``j`` and returns the signatures of the microbatch it opened, and
    ``noise_fn`` draws their noise before segment ``j + 1``.  ``n`` noise
    draws, or none for a slot run as one segment.  Every path records the
    same spans here: one ``host.batch`` a microbatch (the first also holds
    segment 0) and ``host.recover`` around each ``noise_fn`` call."""
    sigs = None
    for bi in range(max(n, 1)):
        with obs_trace.span("host.batch", {"batch": bi}):
            if bi == 0:
                sigs = step(0, None)
            if n:
                with obs_trace.span("host.recover"):
                    noise = noise_fn(sigs)
                sigs = step(bi + 1, noise)


def _run_eager(segs: list, args: tuple, noise_fn: Callable) -> tuple:
    """The segments run eagerly in order; returns ``((state', SlotOutput),
    the last noise)``."""
    x, last = args, None

    def step(j, noise):
        nonlocal x, last
        x, last = (segs[0](*x) if j == 0 else segs[j](x, noise)), noise
        return x.pending.sigs if j < len(segs) - 1 else None

    _drive(step, len(segs) - 1, noise_fn)
    return x, last


# captures, graph replays and eagerly run segments of serve slots
_GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager_segments": 0}
# the captured graphs by key, least recently used first
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPHS_KEPT = 8


def serve_graph_counts() -> dict:
    """How the serve slot ran in this process: ``captures`` (keys whose
    segments were captured as CUDA graphs), ``replays`` (graph launches)
    and ``eager_segments`` (segments run eagerly: on a device that is not
    CUDA, and in the warm-up call that precedes each capture)."""
    return dict(_GRAPH_COUNTS)


class _SlotArgs(NamedTuple):
    """What a serve slot takes."""

    state: HostServerState
    entries: HostPayload
    node_ids: torch.Tensor
    mask: torch.Tensor


class _SlotGraphs:
    """The CUDA graphs of one serve-slot key: its segments captured in order
    on one private memory pool (with the default noise, the whole slot as
    one), replayed in that order around the caller's ``noise_fn``.  The
    inputs are copied into the graphs' own buffers; the last graph writes
    the new state back into its input buffers, and the caller gets clones,
    so every result it holds stays its own."""

    def __init__(self, segs: list, args: _SlotArgs, noise: dict | None,
                 stream) -> None:
        self.args = tree_map(torch.clone, args)
        self.noise = (None if noise is None else
                      {k: torch.empty_like(v) for k, v in noise.items()})
        pool = torch.cuda.graph_pool_handle()
        self.graphs, self.sigs = [], []
        x = None
        for j, seg in enumerate(segs):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=stream):
                x = seg(*self.args) if j == 0 else seg(x, self.noise)
                if j == len(segs) - 1:
                    tree_map(torch.Tensor.copy_, self.args.state, x[0])
            self.graphs.append(g)
            if j < len(segs) - 1:
                self.sigs.append(x.pending.sigs)
        self.out = x[1]

    def run(self, args: _SlotArgs, noise_fn: Callable | None
            ) -> tuple[HostServerState, SlotOutput]:
        result = None

        def step(j, noise):
            nonlocal result
            if j == 0:
                with obs_trace.span("host.ingest"):
                    copy_leaves(self.args, args)
            else:
                copy_leaves(self.noise, noise)
            self.graphs[j].replay()
            if j < len(self.sigs):
                return self.sigs[j].clone()
            with obs_trace.span("host.finish"):
                result = clone(self.args.state), clone(self.out)

        _drive(step, len(self.sigs), noise_fn)
        _GRAPH_COUNTS["replays"] += len(self.graphs)
        return result


def _slot_body(cfg: HostServeConfig, tag: str, state: HostServerState,
               entries: HostPayload, node_ids: torch.Tensor,
               mask: torch.Tensor, host_params: dict,
               gen_params: GeneratorParams, seed: int,
               noise_fn: Callable | None
               ) -> tuple[HostServerState, SlotOutput]:
    """One serve slot: ingest the stamped arrivals, then run
    ``cfg.batches_per_slot`` EDF microbatches through cache, recovery and
    DNN (:func:`_segments`).  On a CUDA device the first call of a key runs
    the segments eagerly on a side stream, then captures them; later calls
    replay the graphs.  Elsewhere, or inside a capture of the caller's, the
    segments run eagerly."""
    dev = state.slot.device
    consts = _slot_consts(cfg, tag, entries.kind.shape[0], dev)
    segs = _segments(cfg, consts, host_params, gen_params)
    draw = noise_fn or functools.partial(counter_noise, seed=seed,
                                         channels=cfg.channels, t=cfg.t)
    args = _SlotArgs(state, entries, node_ids, mask)
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        _GRAPH_COUNTS["eager_segments"] += len(segs)
        return _run_eager(segs, args, draw)[0]
    key = (cfg, tag, dev,
           ("seed", seed) if noise_fn is None else "noise_fn",
           layout(args), layout(host_params, gen_params, addresses=True),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    graphs = _GRAPHS.get(key)
    if graphs is not None:
        _GRAPHS.move_to_end(key)
        return graphs.run(args, noise_fn)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            result, noise = _run_eager(segs, args, draw)
        _GRAPH_COUNTS["eager_segments"] += len(segs)
        caps = segs
        if noise_fn is None:
            # the default noise is tensor work: the slot is one segment
            caps, noise = [lambda *a: _run_eager(segs, a, draw)[0]], None
        _GRAPHS[key] = _SlotGraphs(caps, args, noise, side)
        torch.cuda.current_stream().wait_stream(side)
    compile_event(_GRAPH_COMPONENT, (cfg, tag))
    _GRAPH_COUNTS["captures"] += 1
    while len(_GRAPHS) > _GRAPHS_KEPT:
        _GRAPHS.popitem(last=False)
    return result


def _batch_telemetry(tel: MetricsSpec, metrics: dict, batch, now, missed,
                     hit: torch.Tensor, fresh: torch.Tensor) -> dict:
    """The telemetry lanes of one microbatch: sojourn and end-to-end
    histograms (all, cluster and sampling frames), served, deadline
    misses, cache hits and misses."""
    valid = batch.valid
    sojourn = batch_wait_slots(batch, now)
    is_cluster = valid & (batch.payload.kind == CLUSTER_KIND)
    is_sampling = valid & (batch.payload.kind == SAMPLING_KIND)
    metrics = hist_observe(tel, metrics, "host.sojourn_slots", sojourn, valid)
    metrics = hist_observe(tel, metrics, "host.e2e_slots", sojourn + 1, valid)
    metrics = hist_observe(tel, metrics, "host.sojourn_slots.cluster",
                           sojourn, is_cluster)
    metrics = hist_observe(tel, metrics, "host.sojourn_slots.sampling",
                           sojourn, is_sampling)
    metrics = counter_add(tel, metrics, "host.served", valid)
    metrics = counter_add(tel, metrics, "host.deadline_misses", missed)
    metrics = counter_add(tel, metrics, "host.cache_hits", hit)
    return counter_add(tel, metrics, "host.cache_misses", fresh)


def host_serve_slot(state: HostServerState, entries: HostPayload,
                    node_ids, mask, *, cfg: HostServeConfig,
                    host_params: dict, gen_params: GeneratorParams,
                    seed: int = 0, noise_fn: Callable | None = None
                    ) -> tuple[HostServerState, SlotOutput]:
    """Streaming entry point: one serve slot over a fixed-width ingest lane
    (``entries`` leaves with leading axis A, the lane width; pad a churny
    slot's arrivals to a fixed A and mask the padding).  Returns
    ``(state', SlotOutput)``; feed ``state'`` back in.  The recovery noise
    is ``noise_fn(sigs)``, by default :func:`counter_noise` with ``seed``.
    Runs on the device of ``state``."""
    _check_lane_width(cfg, entries.kind.shape[0])
    with obs_trace.span("host.ingest"):
        dev = state.slot.device
        node_ids = torch.as_tensor(node_ids, device=dev).to(torch.int32)
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    return _slot_body(cfg, "slot", state, entries, node_ids, mask,
                      host_params, gen_params, seed, noise_fn)


def host_serve_trace(state: HostServerState, entries: HostPayload,
                     node_ids, masks, *, cfg: HostServeConfig,
                     host_params: dict, gen_params: GeneratorParams,
                     seed: int = 0, noise_fn: Callable | None = None
                     ) -> tuple[HostServerState, SlotOutput]:
    """Whole-trace entry point: the serve slot over S slots (entry leaves
    (S, A, ...), masks (S, A)), returning the final state and the (S, ...)
    stacked slot outputs.  Chaining two traces equals one long trace."""
    _check_lane_width(cfg, entries.kind.shape[1])
    dev = state.slot.device
    node_ids = torch.as_tensor(node_ids, device=dev).to(torch.int32)
    masks = torch.as_tensor(masks, device=dev).to(torch.bool)
    outs = []
    for si in range(entries.kind.shape[0]):
        state, out = _slot_body(cfg, "trace", state,
                                tree_map(lambda a: a[si], entries),
                                node_ids[si], masks[si], host_params,
                                gen_params, seed, noise_fn)
        outs.append(out)
    return state, SlotOutput(*(torch.stack(xs) for xs in zip(*outs)))


def serve_fleet_payloads(state: HostServerState, wire: WirePayload,
                         node_ids, *, cfg: HostServeConfig,
                         host_params: dict, gen_params: GeneratorParams,
                         seed: int = 0, noise_fn: Callable | None = None,
                         mask=None, node_tasks=None
                         ) -> tuple[HostServerState, SlotOutput]:
    """Ingest one fleet round of cluster payloads and serve enough EDF
    microbatches to cover them at the configured batch size.  ``mask`` is
    the round's (B,) alive mask (a dead node sends no frame); ``node_tasks``
    the (B,) task ids of a mixed fleet."""
    with obs_trace.span("host.ingest"):
        entries = cluster_entries(wire, cfg.m, tasks=node_tasks)
        b = entries.kind.shape[0]
        if b > cfg.queue_capacity:
            raise ValueError(
                f"fleet round of {b} payloads exceeds queue capacity "
                f"{cfg.queue_capacity}; raise HostServeConfig.queue_capacity")
        cfg = dataclasses.replace(cfg,
                                  batches_per_slot=-(-b // cfg.batch_size))
        dev = state.slot.device
        mask = (torch.ones((b,), dtype=torch.bool, device=dev)
                if mask is None else mask)
    return host_serve_slot(state, entries, node_ids, mask, cfg=cfg,
                           host_params=host_params, gen_params=gen_params,
                           seed=seed, noise_fn=noise_fn)


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def host_server_stats(state: HostServerState,
                      cfg: HostServeConfig | None = None) -> dict:
    """QoS counters as Python numbers (synchronises; call off the hot path).
    With ``cfg`` and telemetry lanes in the state, also the QoS percentiles
    ``sojourn_p50/p95/p99`` and ``e2e_p50/p95/p99`` and the full
    :func:`repro_torch.obs.metrics_summary` under ``"telemetry"``."""
    served = int(state.served)
    missed = int(state.deadline_misses)
    dropped = int(state.queue.drops_overflow)
    total = served + missed + dropped
    out = {
        "slot": int(state.slot),
        "served": served,
        "deadline_misses": missed,
        "drops_overflow": dropped,
        "backlog": int(queue_occupancy(state.queue)),
        "deadline_miss_rate": missed / max(total, 1),
        "qos_fail_rate": (missed + dropped) / max(total, 1),
        **cache_stats(state.cache),
    }
    if cfg is not None and cfg.telemetry and state.metrics is not None:
        summary = metrics_summary(host_telemetry_spec(cfg), state.metrics)
        out["telemetry"] = summary
        for key, lane in (("sojourn", "host.sojourn_slots"),
                          ("e2e", "host.e2e_slots")):
            for q in (50, 95, 99):
                out[f"{key}_p{q}"] = summary[lane][f"p{q}"]
    return out


def host_ensemble(state: HostServerState) -> dict:
    """Per-node ensemble answers from the serve history: ``pred_mean``
    (argmax of the mean logits), ``pred_vote`` (majority vote over the
    per-payload argmaxes) and per-node served ``counts``."""
    counts = state.ensemble_votes.sum(dim=-1).to(torch.int32)
    mean_logits = state.ensemble_logits / torch.clamp(
        counts, min=1)[:, None].to(torch.float32)
    return {
        "counts": counts,
        "mean_logits": mean_logits,
        "pred_mean": torch.argmax(mean_logits, dim=-1),
        "pred_vote": torch.argmax(state.ensemble_votes, dim=-1),
    }
