"""Fleet-scale batched Seeker simulator, on one device or node-sharded.

PyTorch counterpart of the bare single-device engine of
:mod:`repro.serving.fleet`: N independent nodes, each with its own
supercapacitor charge, predictor history and AAC continuity, run S time
slots.  The slot loop is a Python loop over one batched step; within a slot
nothing loops over nodes:

1. one :func:`repro_torch.kernels.ops.signature_corr_op` launch correlates
   every node's window with the signature bank;
2. :func:`repro_torch.serving.edge_host.seeker_sensor_step_given_corr`
   runs the ladder, D2 (three :func:`fake_quant_op` launches), D3 (one
   :func:`kmeans_coreset_op` launch over all N·C channel clouds) and D4 for
   the whole fleet;
3. :func:`repro_torch.serving.edge_host.seeker_host_step` recovers and
   classifies every offloaded window;
4. the fleet aggregates are reduced once, after the last slot.

On a CUDA device the slot loop is captured as CUDA graphs, one a slot of
the call, the first time a key (shapes, lanes and their configs, the
weights' addresses) is called, and replayed after (:func:`_run_slots`);
:func:`fleet_graph_counts` counts captures, replays and slots run
eagerly.

Every driver marks these steps with :mod:`repro_torch.obs.trace` spans:
``fleet.step`` around the call, ``fleet.prepare``, one ``fleet.slot`` a
slot holding ``fleet.noise``, then per node block ``fleet.corr``,
``fleet.sensor``, ``fleet.intermittent`` (when on) and ``fleet.host``, then
``fleet.carry``; and ``fleet.aggregates``.  A replayed slot records its
``fleet.slot`` alone.  The node-sharded engine adds
``fleet.tile`` inside ``fleet.prepare`` (its rank's tile of the global
inputs and of the carried state) and ``fleet.collect`` inside
``fleet.aggregates`` (the all-reduce of the counts and the gathers of the
traces and the carry).

Randomness comes from one of three sources, and a run takes one:

* ``generator=`` (the default, ``manual_seed(0)``): every slot draws its
  (N, ...) batch of D4 and recovery noise from one ``torch.Generator`` on
  the device (:func:`draw_slot_noise`);
* ``noise=``: a dict of pre-drawn (S, N, ...) tensors — how the parity
  tests hand the port the numbers JAX drew;
* ``node_keys=`` ((N, 2) words, :func:`fleet_node_keys`): node ``i`` draws
  from a counter hash of its own key (:func:`draw_slot_noise_keyed`), and
  its key advances in each slot it runs, as the reference's per-node
  ``fold_in(key, i)`` streams do.  A fleet of N nodes then draws what N
  one-node runs draw, a shard hashes only its own nodes' keys, and
  ``final_keys`` resumes the streams.

Lanes (:mod:`repro_torch.serving.fleet_lanes`), as in the JAX engine:

* churn (``alive=``): in a dead slot a node freezes its whole carry and
  emits DEFER with a zero payload;
* brown-out (``brownout=``): the ladder turns strict (a decision is paid
  from ``stored + harvested`` alone) and a supercap-hysteresis flag in the
  carry takes a node down below ``off_uj`` and back at ``restart_uj``; a
  browned-out node freezes like a dead one while its supercap still
  trickle-charges;
* intermittent inference (``intermittent=``, with ``aux_params=``): after
  the ladder, :func:`repro_torch.serving.edge_host.intermittent_lane_step`
  turns DEFER slots into staged progress (D6), early exits (D7) and
  full-depth results (D8), with three more ``fake_quant`` launches per
  slot (stage 0 two, stage 1 one) and two per run for the auxiliary heads.

* tasks (``task=``, ``tasks=``): each node has a static task id (HAR
  wearables and bearing monitors in one fleet) that scales its whole cost
  ladder, optionally picks its host weights (``per_task_host``: one
  :func:`seeker_host_step` per task on that task's nodes), and splits the
  completion, deadline-miss and accuracy counts per task;
* telemetry (``telemetry=``): registry lanes
  (:func:`fleet_telemetry_spec`, exact int32 counters, the decision
  histogram, a stored-energy gauge) advanced each slot from the same masked
  values the aggregates reduce; the lanes' counters are summed in one
  stacked reduction per slot.

:func:`seeker_fleet_simulate_streamed` feeds the engine in segments of
``chunk`` slots, chained through the resume arguments, so only one segment
of windows exists at a time while every trace and counter is bitwise one
long run.

:func:`seeker_fleet_simulate_sharded` splits the node axis over the ranks
of a ``torch.distributed`` device mesh (:mod:`repro_torch.sharding`): each
rank runs the same slot loop on its node tile, and only the aggregates,
the telemetry lanes and, after the last slot, the traces cross ranks.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.aac import AACTable
from ..core.coreset import raw_payload_bytes
from ..core.counter_hash import (MASK32, box_muller, counter_words, counters,
                                 fmix32, word_uniforms)
from ..core.decision import (D4_SAMPLING, DEFER, N_INTERMITTENT_DECISIONS,
                             IntermittentConfig)
from ..core.energy import (BrownoutConfig, EnergyCosts, predictor_init,
                           supercap_step)
from ..graph_io import clone, copy_leaves, layout, tree_map
from ..kernels.ops import signature_corr_op
from ..models.har import HARConfig, quantize_params
from ..obs import (MetricsSpec, categorical_counts, counters_add,
                   metrics_init, metrics_merge, metrics_psum, spec_union)
from ..obs import trace as obs_trace
from ..obs.compile_guard import compile_event
from ..sharding import (NodeShard, all_gather_tiles, all_reduce_sum,
                        make_mesh, node_shard)
from .edge_host import (IntermittentState, SeekerNodeState,
                        intermittent_fleet_init, intermittent_lane_step,
                        seeker_host_step, seeker_sensor_step_given_corr)
from .fleet_lanes import (FLEET_LANES, N_DECISIONS, FleetCarry,
                          TaskLaneConfig, _completed, fleet_counter_keys,
                          fleet_task_assignment, fleet_telemetry_lanes,
                          fleet_trace_keys)

__all__ = ["N_DECISIONS", "NOISE_KEYS", "resolve_device", "to_device",
           "fleet_node_init", "fleet_node_keys", "draw_slot_noise",
           "draw_slot_noise_keyed", "draw_fleet_noise",
           "fleet_graph_counts", "fleet_telemetry_spec",
           "seeker_fleet_simulate",
           "seeker_fleet_simulate_sharded", "seeker_fleet_simulate_streamed",
           "wire_bytes_exact"]

NOISE_KEYS = ("u", "dirs", "radii_u", "latent")
LATENT = 16
# the node keys' salts (the seed's low and high words) and the row salt of
# a slot's draw: digits of pi
_KEY_SALTS = (0x243F6A88, 0x85A308D3)
_ROW_SALT = 0x13198A2E


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without a CUDA device that raises instead of
    running on the CPU.  Pass ``device="cpu"`` for the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless asked otherwise, and no "
                "CUDA device is available; pass device='cpu' to run the "
                "kernels' plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_device(x, device=None, dtype: torch.dtype | None = None):
    """A tensor, numpy array or nested NamedTuple/dict of them, on
    :func:`resolve_device` (``device``)."""
    dev = resolve_device(device)
    if isinstance(x, dict):
        return {k: to_device(v, dev, dtype) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, dev, dtype) for v in x))
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x))
    return x.to(device=dev, dtype=dtype or x.dtype)


def _active_lanes(intermittent: IntermittentConfig | None = None,
                  task: TaskLaneConfig | None = None,
                  brownout: BrownoutConfig | None = None) -> frozenset:
    """The run's active-lane tags; ``task:K`` carries the task count, so
    pure functions of the set (the telemetry spec) can size per-task
    lanes."""
    active = set()
    if brownout is not None:
        active.add("brownout")
    if intermittent is not None:
        active.add("intermittent")
    if task is not None:
        active.update({"task", f"task:{task.n_tasks}"})
    return frozenset(active)


def fleet_telemetry_spec(intermittent: bool = False,
                         n_tasks: int = 0) -> MetricsSpec:
    """The fleet's registry lanes, the union of the lanes each registered
    :class:`~repro_torch.serving.fleet_lanes.FleetLane` owns: the node lane
    ``fleet.wire_bytes``, ``fleet.completed``, ``fleet.alive_slots``,
    ``fleet.stored_uj`` and ``fleet.decisions``; brown-out
    ``fleet.brownout_*``; the intermittent lane ``fleet.it_*``; the task
    lane ``fleet.task_completed``.  All int32.  Memoized on the lane set,
    so equal lane sets return the same object."""
    active = set()
    if intermittent:
        active.add("intermittent")
    if n_tasks:
        active.update({"task", f"task:{n_tasks}"})
    return _fleet_telemetry_spec_cached(frozenset(active))


@functools.lru_cache(maxsize=8)
def _fleet_telemetry_spec_cached(active: frozenset) -> MetricsSpec:
    return spec_union(fleet_telemetry_lanes(active))


def _resolve_telemetry(telemetry, intermittent: IntermittentConfig | None,
                       task: TaskLaneConfig | None = None
                       ) -> MetricsSpec | None:
    """``True``: the registry's lanes for this run's lanes; a
    :class:`MetricsSpec` passes through; ``None`` (or ``False``) is off."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return fleet_telemetry_spec(intermittent is not None,
                                    task.n_tasks if task is not None else 0)
    if not isinstance(telemetry, MetricsSpec):
        raise TypeError(f"telemetry must be None/True/MetricsSpec, "
                        f"got {type(telemetry).__name__}")
    return telemetry


def _update_fleet_lanes(spec: MetricsSpec, metrics: dict, out_trace: dict,
                        exo_alive_t: torch.Tensor, active: frozenset,
                        tasks: torch.Tensor | None = None,
                        stack_counters: bool = True) -> dict:
    """Advance every registry lane by one slot: each active lane's
    ``telemetry_update`` folded over the metrics, from the slot's masked
    trace (the values the aggregates reduce).  With ``stack_counters`` the
    lanes' counters are collected and added in one stacked reduction
    (:func:`repro_torch.obs.counters_add`), bit for bit the lane-by-lane
    fold."""
    pending = [] if stack_counters else None
    m = metrics
    for ln in FLEET_LANES:
        if ln.telemetry_update is not None and ln.active(active):
            m = ln.telemetry_update(spec, m, out_trace,
                                    exo_alive_t=exo_alive_t, active=active,
                                    tasks=tasks, counters=pending)
    return m if pending is None else counters_add(spec, m, pending)


def fleet_node_init(n_nodes: int, predictor_window: int = 8,
                    initial_uj: float = 50.0, device=None) -> SeekerNodeState:
    """Stacked state for ``n_nodes`` nodes (leading node axis on every
    leaf)."""
    dev = resolve_device(device)
    return SeekerNodeState(
        stored_uj=torch.full((n_nodes,), initial_uj, dtype=torch.float32,
                             device=dev),
        predictor=predictor_init(predictor_window, batch=n_nodes, device=dev),
        prev_label=torch.zeros((n_nodes,), dtype=torch.int32, device=dev))


def fleet_node_keys(seed: int, n: int, device=None) -> torch.Tensor:
    """(n, 2) per-node noise keys, two 32-bit words a node (int64 tensors
    in ``[0, 2**32)``), hashed from (``seed``, node index) alone: the keys
    of a fleet of ``m`` nodes are the first ``m`` keys of any larger one,
    so node ``i``'s stream is the same in every fleet and shard layout —
    the counterpart of the reference's ``fold_in(key, i)``, with other
    numbers."""
    dev = resolve_device(device)
    lo = fmix32((seed & MASK32) ^ _KEY_SALTS[0])
    hi = fmix32(((seed >> 32) & MASK32) ^ _KEY_SALTS[1])
    k0 = fmix32(counters(n, dev) ^ lo)
    return torch.stack([k0, fmix32(k0 ^ hi)], dim=1)


def draw_slot_noise_keyed(keys: torch.Tensor, t: int, c: int,
                          latent: int = LATENT
                          ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """One slot's noise for the nodes of ``keys`` (N, 2), each row from a
    counter hash of its own key (:mod:`repro_torch.core.counter_hash`),
    with :func:`draw_slot_noise`'s keys, shapes and ranges; and each
    node's advanced key, the two words after its draws.  A row's numbers
    depend on its key alone, not on the batch it is drawn in."""
    n = keys.shape[0]
    n_dir, n_rad = c * t * 2, c * t
    n_norm = n_dir + latent
    row = fmix32(fmix32(keys[:, 0] ^ _ROW_SALT) ^ keys[:, 1])
    h = counter_words(row, t + 2 * n_norm + n_rad + 2)
    u = word_uniforms(h[:, :-2])                                # (0, 1]
    ug, u1 = u[:, :t], u[:, t:t + n_norm]
    u2, ur = u[:, t + n_norm:t + 2 * n_norm], u[:, t + 2 * n_norm:]
    z = box_muller(u1, u2)
    noise = {"u": torch.clamp(1.0 - ug, min=1e-9),
             "dirs": z[:, :n_dir].reshape(n, c, t, 2),
             "radii_u": (1.0 - ur).reshape(n, c, t, 1),
             "latent": z[:, n_dir:]}
    return noise, h[:, -2:]


def draw_slot_noise(generator: torch.Generator, n: int, t: int, c: int,
                    latent: int = LATENT) -> dict[str, torch.Tensor]:
    """One slot's noise for ``n`` nodes, on the generator's device:

    * ``u`` (N, T): D4's Gumbel uniforms in [1e-9, 1);
    * ``dirs`` (N, C, T, 2), ``radii_u`` (N, C, T, 1): the cluster
      recovery's ball directions (normal) and radii (uniform);
    * ``latent`` (N, 16): the sampling recovery's generator input."""
    dev = generator.device
    return {
        "u": torch.clamp(torch.rand((n, t), generator=generator, device=dev),
                         min=1e-9),
        "dirs": torch.randn((n, c, t, 2), generator=generator, device=dev),
        "radii_u": torch.rand((n, c, t, 1), generator=generator, device=dev),
        "latent": torch.randn((n, latent), generator=generator, device=dev),
    }


def draw_fleet_noise(generator: torch.Generator, s: int, n: int, t: int,
                     c: int, latent: int = LATENT) -> dict[str, torch.Tensor]:
    """(S, N, ...) noise for a whole run, drawn slot by slot in the order
    :func:`seeker_fleet_simulate` draws it: the same generator state gives
    the same numbers as a run with ``generator=``."""
    slots = [draw_slot_noise(generator, n, t, c, latent) for _ in range(s)]
    return {k: torch.stack([sl[k] for sl in slots]) for k in NOISE_KEYS}


def _as_array(x):
    """A tensor or numpy array as given (anything else through numpy), for
    shape checks that move no data."""
    return x if isinstance(x, (torch.Tensor, np.ndarray)) else np.asarray(x)


def _check_noise(noise: dict, s: int, n: int, t: int, c: int, take):
    """Pre-drawn noise checked against the (S, N, ...) shapes of
    :func:`draw_slot_noise`; ``take`` moves each array where the run needs
    it (the whole of it, or one rank's node tile)."""
    want = {"u": (s, n, t), "dirs": (s, n, c, t, 2),
            "radii_u": (s, n, c, t, 1), "latent": (s, n, LATENT)}
    out = {}
    for k, shape in want.items():
        if k not in noise:
            raise ValueError(f"noise lacks {k!r}; it needs {sorted(want)}")
        v = _as_array(noise[k])
        if tuple(v.shape) != shape:
            raise ValueError(f"noise[{k!r}] must be {shape}, got "
                             f"{tuple(v.shape)}")
        out[k] = take(v)
    return out


def _check_sources(generator, noise, node_keys) -> None:
    """A run takes its noise from one source at most."""
    given = [k for k, v in (("generator", generator), ("noise", noise),
                            ("node_keys", node_keys)) if v is not None]
    if len(given) > 1:
        raise ValueError(f"pass one of generator=, noise= and node_keys=, "
                         f"got {' and '.join(given)}")


def _check_keys(node_keys, n: int, take) -> torch.Tensor:
    """(N, 2) integer node keys, moved by ``take``."""
    v = _as_array(node_keys)
    if tuple(v.shape) != (n, 2):
        raise ValueError(f"node_keys must be (N, 2)=({n}, 2), got "
                         f"{tuple(v.shape)}")
    if torch.as_tensor(v[:0]).is_floating_point():
        raise ValueError("node_keys are integer words (fleet_node_keys)")
    return take(v)


def _labels_layout(labels, s: int, n: int, shared_stream: bool):
    """(labels, per_node), labels as given: a shared (S,) track (only with a
    shared stream) or per-node (S, N) tracks, validated like the JAX
    engine."""
    if labels is None:
        return None, False
    labels = _as_array(labels)
    accepted = (f"accepted forms: (S,)=({s},) shared-stream track, or "
                f"(S, N)=({s}, {n}) per-node tracks")
    if tuple(labels.shape) == (s, n):
        return labels, True
    if tuple(labels.shape) == (s,):
        if not shared_stream and n != 1:
            raise ValueError(
                f"labels shape {tuple(labels.shape)} is ambiguous with "
                f"per-node (N, S, T, C) window streams: pass per-node "
                f"(S, N)=({s}, {n}) labels or a shared (S, T, C) stream; "
                f"{accepted}.")
        return labels, False
    raise ValueError(f"labels must be one of the accepted forms, got shape "
                     f"{tuple(labels.shape)}; {accepted}.")


def _resolve_labels(labels, s: int, n: int, shared_stream: bool, dev):
    """:func:`_labels_layout`, the labels on ``dev`` as int64."""
    labels, per_node = _labels_layout(labels, s, n, shared_stream)
    if labels is None:
        return None, False
    return to_device(labels, dev, torch.int64), per_node


def _check_alive(alive, n: int, s: int):
    """The (N, S) churn trace as given, shape-checked (``None`` stays)."""
    if alive is None:
        return None
    alive = _as_array(alive)
    if tuple(alive.shape) != (n, s):
        raise ValueError(f"alive must be (N, S)=({n}, {s}) bool, got "
                         f"{tuple(alive.shape)}")
    return alive


def _resolve_alive(alive, n: int, s: int, dev) -> torch.Tensor:
    """(N, S) bool churn trace; ``None`` is the always-present fleet."""
    alive = _check_alive(alive, n, s)
    if alive is None:
        return torch.ones((n, s), dtype=torch.bool, device=dev)
    return to_device(alive, dev, torch.bool)


def _resolve_brownout0(brownout_state0, state0: SeekerNodeState,
                       brownout: BrownoutConfig | None, n: int
                       ) -> torch.Tensor:
    """(N,) bool brown-out flag entering slot 0: a resumed flag (a previous
    run's ``final_brownout``), else boot-time hysteresis (a node whose
    initial charge is under ``off_uj`` boots browned out), else all False
    when the lane is off."""
    dev = state0.stored_uj.device
    if brownout_state0 is not None:
        browned0 = to_device(brownout_state0, dev, torch.bool)
        if tuple(browned0.shape) != (n,):
            raise ValueError(f"brownout_state0 must be (N,)=({n},) bool, "
                             f"got {tuple(browned0.shape)}")
        return browned0
    if brownout is not None:
        return state0.stored_uj < brownout.off_uj
    return torch.zeros((n,), dtype=torch.bool, device=dev)


def _validate_intermittent_args(intermittent, intermittent_state0,
                                aux_params, n: int) -> None:
    """Refuse half-configured intermittent runs: the lane needs its
    auxiliary heads, and a lane state without the lane would be dropped."""
    if intermittent is None:
        if intermittent_state0 is not None:
            raise ValueError(
                "intermittent_state0 was passed but intermittent is None: a "
                "resumed lane state without the lane enabled would be "
                "silently dropped; pass the IntermittentConfig too")
        return
    if aux_params is None:
        raise ValueError(
            "intermittent inference needs the early-exit auxiliary heads: "
            "pass aux_params=har_aux_init(generator, har_cfg)")
    if intermittent_state0 is not None:
        lead = intermittent_state0.stage.shape[0]
        if lead != n:
            raise ValueError(f"intermittent_state0 is stacked for {lead} "
                             f"nodes, fleet has {n}")


def _resolve_tasks(tasks, task: TaskLaneConfig | None, n: int, dev
                   ) -> tuple[torch.Tensor | None, TaskLaneConfig | None]:
    """The task lane's (N,) int32 ids and config: ``task`` alone takes the
    round-robin :func:`fleet_task_assignment`, ``tasks`` alone the default
    two-task :class:`TaskLaneConfig`; ids are checked against the task
    count."""
    if tasks is None and task is None:
        return None, None
    if task is None:
        task = TaskLaneConfig()
    if tasks is None:
        tasks = fleet_task_assignment(n, task.n_tasks, dev)
    tasks = to_device(tasks, dev, torch.int32)
    if tuple(tasks.shape) != (n,):
        raise ValueError(f"tasks must be (N,)=({n},) per-node task ids, "
                         f"got {tuple(tasks.shape)}")
    lo, hi = int(tasks.min()), int(tasks.max())
    if lo < 0 or hi >= task.n_tasks:
        raise ValueError(
            f"tasks ids span [{lo}, {hi}] but the TaskLaneConfig declares "
            f"{task.n_tasks} tasks {task.names}")
    return tasks, task


def _resolve_task_host(task: TaskLaneConfig | None, host_params):
    """With ``per_task_host``, ``host_params`` must be one tree per task;
    they stay a tuple, and each task's nodes run through their own."""
    if task is None or not task.per_task_host:
        return host_params
    if not isinstance(host_params, (tuple, list)):
        raise ValueError(
            f"per_task_host=True needs host_params as a sequence of "
            f"{task.n_tasks} per-task param trees "
            f"(one per {task.names}), got {type(host_params).__name__}")
    if len(host_params) != task.n_tasks:
        raise ValueError(
            f"per_task_host=True needs {task.n_tasks} host param trees "
            f"for tasks {task.names}, got {len(host_params)}")
    return tuple(host_params)


def _host_logits(out, nz, host_idx, *, host_params, gen_params, t):
    """Host logits of a block: one :func:`seeker_host_step` over every
    node, or, with per-task host weights (``host_idx``: each task's node
    indices in the block), one per task on its nodes, scattered back."""
    if host_idx is None:
        return seeker_host_step(out, nz["dirs"], nz["radii_u"], nz["latent"],
                                host_params=host_params,
                                gen_params=gen_params, t=t)
    sensor = out._replace(state=None)
    logits = torch.zeros_like(out.logits)
    for params, idx in zip(host_params, host_idx):
        if idx.numel() == 0:
            continue
        part = seeker_host_step(
            tree_map(lambda x: x[idx], sensor), nz["dirs"][idx],
            nz["radii_u"][idx], nz["latent"][idx], host_params=params,
            gen_params=gen_params, t=t)
        logits = logits.index_copy(0, idx, part)
    return logits


def _slot_body(state, it, win, harv, nz, slot, cost_scale, host_idx, *,
               signatures, qp, qa, host_params, gen_params, aac_table, costs,
               quant_bits, k_max, m_samples, corr_threshold, har_cfg, strict,
               intermittent, reserve_uj):
    """The slot for one block of nodes: correlation, sensor step, the
    intermittent lane (when on), host.  ``cost_scale`` is the block's task
    lane scale (or None)."""
    with obs_trace.span("fleet.corr"):
        corr = signature_corr_op(win, signatures)                 # (B, L)
    with obs_trace.span("fleet.sensor"):
        out = seeker_sensor_step_given_corr(
            win, state, harv, corr, nz["u"], qp=qp, aac_table=aac_table,
            costs=costs, k_max=k_max, m_samples=m_samples,
            quant_bits=quant_bits, corr_threshold=corr_threshold,
            strict_energy=strict, cost_scale=cost_scale)
    lane_trace, new_it = {}, None
    if intermittent is not None:
        with obs_trace.span("fleet.intermittent"):
            # the lane overrides the slots it engages, after the ladder
            lane = intermittent_lane_step(
                win, state, harv, out.decision, it, slot, qp=qp, qa=qa,
                har_cfg=har_cfg, costs=costs, quant_bits=quant_bits,
                cfg=intermittent, reserve_uj=reserve_uj, cost_scale=cost_scale)
            eng = lane.engaged
            # label -1 on engaged slots: their one-hot host logits are zeros,
            # and the lane's result is scored through the it_* traces
            out = out._replace(
                decision=torch.where(eng, lane.decision, out.decision),
                payload_bytes=torch.where(eng, lane.payload_bytes,
                                          out.payload_bytes),
                label_or_neg=torch.where(eng, -1, out.label_or_neg),
                state=SeekerNodeState(
                    stored_uj=torch.where(eng, lane.stored_uj,
                                          out.state.stored_uj),
                    predictor=out.state.predictor,
                    prev_label=torch.where(eng, lane.prev_label,
                                           out.state.prev_label)))
            new_it = lane.state
            lane_trace = {"it_emit": lane.emit, "it_label": lane.emit_label,
                          "it_conf": lane.emit_conf, "it_src": lane.emit_src,
                          "it_stage": lane.emit_stage}
    with obs_trace.span("fleet.host"):
        logits = _host_logits(out, nz, host_idx, host_params=host_params,
                              gen_params=gen_params, t=win.shape[-2])
    return out.state, new_it, {"decisions": out.decision,
                               "payload_bytes": out.payload_bytes,
                               "k_trace": out.coreset_k, "logits": logits,
                               **lane_trace}


def _label_scores(traces: dict, labels: torch.Tensor, per_node: bool,
                  intermittent: IntermittentConfig | None, slot0: int,
                  tasks: torch.Tensor | None,
                  task: TaskLaneConfig | None) -> dict:
    """The counts scored against labels: ``correct`` and, with the
    intermittent lane, ``correct_ladder`` and ``it_correct_*`` (each lane
    emission against the label of its source slot ``it_src``; one from
    before ``slot0`` is not scored); with the task lane ``correct_by_task``.
    The streamed driver calls it once over the concatenated traces."""
    act, dec = traces["alive"], traces["decisions"]
    sent = _completed(dec, act, intermittent is not None)
    ok = ((traces["preds"] == labels) if per_node
          else (traces["preds"] == labels[:, None]))
    by_task = (None if task is None else functools.partial(
        categorical_counts, tasks[None, :].expand(act.shape), task.n_tasks))
    if intermittent is None:
        out = {"correct": (ok & sent).sum()}
        if by_task is not None:
            out["correct_by_task"] = by_task(ok & sent)
        return out
    rel = traces["it_src"] - slot0
    valid = (traces["it_emit"] > 0) & act & (rel >= 0)
    rel_c = rel.clamp(0, dec.shape[0] - 1).long()
    lab = torch.gather(labels, 0, rel_c) if per_node else labels[rel_c]
    it_ok = (traces["it_label"] == lab) & valid
    parts = {"correct_ladder": ok & sent & (dec <= D4_SAMPLING),
             "it_correct_full": it_ok & (traces["it_emit"] == 2),
             "it_correct_early": it_ok & (traces["it_emit"] == 1)}
    out = {k: v.sum() for k, v in parts.items()}
    out["correct"] = (out["correct_ladder"] + out["it_correct_full"]
                      + out["it_correct_early"])
    if by_task is not None:
        out["correct_by_task"] = sum(by_task(v) for v in parts.values())
    return out


def _fleet_aggregates(traces: dict, exo_alive: torch.Tensor, labels,
                      per_node: bool,
                      intermittent: IntermittentConfig | None,
                      slot0: int, tasks: torch.Tensor | None = None,
                      task: TaskLaneConfig | None = None,
                      mask: torch.Tensor | None = None) -> dict:
    """Masked fleet aggregates from (S, N) traces.  The activity mask is
    the emitted alive lane (exogenous and not browned out); ``exo_alive``
    is the exogenous trace alone, which counts the slots the brown-out
    hysteresis took.

    With the intermittent lane a D6 suspension is no completion and the
    histogram has the 9 codes.  With the task lane the completions and
    misses (an alive slot that put nothing on the wire missed its
    deadline) split per task id.  ``mask`` (N,) takes the sharded
    engine's padding nodes out of every count."""
    if mask is not None:
        traces = dict(traces, **{k: traces[k] & mask[None, :]
                                 for k in ("alive", "brownout", "bo_event")})
    act = traces["alive"]
    dec = traces["decisions"]
    sent = _completed(dec, act, intermittent is not None)
    n_bins = (N_DECISIONS if intermittent is None
              else N_INTERMITTENT_DECISIONS)
    payload = traces["payload_bytes"]
    aggs = {
        "bytes_on_wire": torch.where(act, payload, 0.0).sum(),
        # payloads are whole bytes; int64 keeps the fleet total exact
        "bytes_on_wire_exact": torch.where(
            act, torch.round(payload).to(torch.int64), 0).sum(),
        "decision_histogram": torch.bincount(dec[act].long(),
                                             minlength=n_bins),
        "completed": sent.sum(),
        "alive_slots": act.sum(),
        "brownout_slots": (traces["brownout"] & exo_alive).sum(),
        "brownout_events": traces["bo_event"].sum(),
    }
    if intermittent is not None:
        emit = traces["it_emit"]
        aggs["it_full"] = ((emit == 2) & act).sum()
        aggs["it_early"] = ((emit == 1) & act).sum()
    if task is not None:
        tasks_b = tasks[None, :].expand(act.shape)
        aggs["completed_by_task"] = categorical_counts(tasks_b, task.n_tasks,
                                                       sent)
        aggs["deadline_miss_by_task"] = categorical_counts(
            tasks_b, task.n_tasks, act & ~sent)
    if labels is not None:
        aggs.update(_label_scores(traces, labels, per_node, intermittent,
                                  slot0, tasks, task))
    return aggs


def seeker_fleet_simulate(windows, harvest, *, signatures, qdnn_params,
                          host_params, gen_params, har_cfg: HARConfig,
                          aac_table: AACTable | None = None,
                          costs: EnergyCosts | None = None,
                          generator: torch.Generator | None = None,
                          noise: dict | None = None,
                          node_keys=None, quant_bits: int = 16,
                          k_max: int = 12, m_samples: int = 20,
                          corr_threshold: float = 0.95,
                          predictor_window: int = 8, initial_uj: float = 50.0,
                          state0: SeekerNodeState | None = None,
                          labels=None, alive=None,
                          brownout: BrownoutConfig | None = None,
                          brownout_state0=None,
                          intermittent: IntermittentConfig | None = None,
                          intermittent_state0: IntermittentState | None = None,
                          aux_params: dict | None = None, slot0: int = 0,
                          telemetry=None, telemetry_state0: dict | None = None,
                          tasks=None, task: TaskLaneConfig | None = None,
                          node_block: int | None = None, device=None):
    """Simulate N independent Seeker nodes over S time slots.

    Args:
        windows: (S, T, C) — one stream shared by every node, or
            (N, S, T, C) — a stream per node.
        harvest: (N, S) µJ harvested per node per slot.
        generator: ``torch.Generator`` on ``device`` for the per-slot noise;
            default ``manual_seed(0)`` when neither ``noise`` nor
            ``node_keys`` is given.
        noise: optional dict of pre-drawn (S, N, ...) tensors with the keys
            and per-slot shapes of :func:`draw_slot_noise`.
        node_keys: optional (N, 2) per-node keys (:func:`fleet_node_keys`,
            or a previous run's ``final_keys`` to resume the streams): each
            node draws by :func:`draw_slot_noise_keyed`, and its key
            advances in the slots it runs (frozen through dead and
            browned-out ones).  ``generator``, ``noise`` and ``node_keys``
            exclude each other.
        state0: optional stacked :class:`SeekerNodeState` to resume from.
        labels: optional (S,) shared-stream or (S, N) per-node ground truth
            for ``correct``/``fleet_accuracy``.
        alive: optional (N, S) bool churn trace
            (:func:`repro_torch.core.energy.fleet_alive_traces`).
        brownout: optional :class:`repro_torch.core.energy.BrownoutConfig`;
            ``brownout_state0`` resumes its (N,) flag (default: boot-time
            hysteresis on the initial charge).
        intermittent: optional
            :class:`repro_torch.core.decision.IntermittentConfig`; needs
            ``aux_params`` (:func:`repro_torch.models.har.har_aux_init`).
            ``intermittent_state0`` resumes a stacked lane state and
            ``slot0`` is the global index of this run's first slot.
        telemetry: ``True`` (the lanes of :func:`fleet_telemetry_spec` for
            this run's lanes) or a :class:`repro_torch.obs.MetricsSpec`:
            the registry lanes come back under ``res["telemetry"]`` (int32
            tensors) with ``res["telemetry_spec"]``.  ``telemetry_state0``
            (a previous run's ``res["telemetry"]``) is merged in after the
            run (:func:`repro_torch.obs.metrics_merge`).
        tasks: optional (N,) int32 task ids; ``task`` the
            :class:`repro_torch.serving.fleet_lanes.TaskLaneConfig` (either
            alone takes the other's default: round-robin ids, or the
            two-task HAR and bearing config).  The task's ``cost_scale``
            scales each node's ladder and lane costs; with
            ``per_task_host`` ``host_params`` is one tree per task.
        node_block: run each slot in node blocks of this size (bounds the
            slot's working memory; more kernel launches per slot).
        device: ``None`` is CUDA (raises without it); ``"cpu"`` runs the
            kernels' plain versions.

    Returns a dict of time-major (S, N) traces — ``decisions``,
    ``payload_bytes``, ``stored_uj``, ``k_trace``, ``logits`` (S, N, L),
    ``preds``, ``alive`` (the emitted lane: exogenous and not browned out)
    and ``brownout`` (the flag each slot was entered with) — the
    aggregates ``bytes_on_wire`` (float32), ``bytes_on_wire_exact`` (int64,
    see :func:`wire_bytes_exact`), ``decision_histogram``, ``completed``,
    ``alive_slots``, ``completed_frac``, ``brownout_slots``,
    ``brownout_events`` and ``raw_bytes_per_window``, with labels
    ``correct`` and ``fleet_accuracy``, and ``final_state`` and
    ``final_brownout`` (and ``final_keys`` with ``node_keys``).  With
    ``intermittent`` also the traces ``it_emit``
    (0 none, 1 early exit, 2 full depth), ``it_label``, ``it_conf``,
    ``it_src`` and ``it_stage``, the counters ``it_full`` and ``it_early``
    (with labels ``correct_ladder``, ``it_correct_full`` and
    ``it_correct_early``; ``correct`` is then their sum) and
    ``final_intermittent``.  With the task lane ``task_names``, ``tasks``,
    ``completed_by_task`` and ``deadline_miss_by_task`` (with labels
    ``correct_by_task`` and ``accuracy_by_task``).
    """
    n, s = tuple(_as_array(harvest).shape)
    with obs_trace.span("fleet.step", {"nodes": n, "slots": s}):
        with obs_trace.span("fleet.prepare"):
            dev = resolve_device(device)
            _check_sources(generator, noise, node_keys)
            costs = costs or EnergyCosts()
            harvest = to_device(harvest, dev, torch.float32)
            windows = to_device(windows, dev, torch.float32)
            shared_stream = _check_windows(tuple(windows.shape), n, s,
                                           har_cfg)
            t, c = windows.shape[-2:]
            xs_w = (windows.contiguous() if shared_stream      # (S, T, C)
                    else windows.transpose(0, 1))               # (S, N, T, C)
            labels, per_node_labels = _resolve_labels(labels, s, n,
                                                      shared_stream, dev)
            exo_alive = _resolve_alive(alive, n, s, dev)
            if state0 is None:
                state = fleet_node_init(n, predictor_window, initial_uj, dev)
            else:
                state = to_device(state0, dev)
                if state.stored_uj.shape[0] != n:
                    raise ValueError(f"state0 is stacked for "
                                     f"{state.stored_uj.shape[0]} nodes, "
                                     f"fleet has {n}")
            _validate_intermittent_args(intermittent, intermittent_state0,
                                        aux_params, n)
            tasks, task = _resolve_tasks(tasks, task, n, dev)
            host_params = _resolve_task_host(task, host_params)
            tel_spec = _resolve_telemetry(telemetry, intermittent, task)
            active = _active_lanes(intermittent, task, brownout)
            it = None
            if intermittent is not None:
                it = (intermittent_fleet_init(n, har_cfg, dev)
                      if intermittent_state0 is None
                      else to_device(intermittent_state0, dev))
            keys0 = draw = None
            if noise is not None:
                noise = _check_noise(
                    noise, s, n, t, c,
                    lambda v: to_device(v, dev, torch.float32))
            elif node_keys is not None:
                keys0 = _check_keys(node_keys, n,
                                    lambda v: to_device(v, dev, torch.int64))
            else:
                draw = functools.partial(
                    draw_slot_noise, _check_generator(generator, dev), n, t, c)
            carry = FleetCarry(
                node=state, keys=keys0, intermittent=it,
                # the run counts a delta from zero; telemetry_state0 is
                # merged after
                telemetry=(None if tel_spec is None
                           else metrics_init(tel_spec, dev)),
                brownout=_resolve_brownout0(brownout_state0, state, brownout,
                                            n))
            params, own_weights = _model_params(
                signatures=signatures, qdnn_params=qdnn_params,
                host_params=host_params, gen_params=gen_params,
                aac_table=aac_table, costs=costs, quant_bits=quant_bits,
                k_max=k_max, m_samples=m_samples,
                corr_threshold=corr_threshold, har_cfg=har_cfg,
                brownout=brownout, intermittent=intermittent,
                aux_params=aux_params, task=task, dev=dev)
        traces, carry = _run_slots(
            xs_w, harvest, exo_alive, carry, noise=noise, draw=draw,
            params=params, own_weights=own_weights, tasks=tasks, task=task,
            brownout=brownout, intermittent=intermittent, tel_spec=tel_spec,
            active=active, slot0=slot0, node_block=node_block)
        with obs_trace.span("fleet.aggregates"):
            aggs = _fleet_aggregates(traces, exo_alive.T, labels,
                                     per_node_labels, intermittent, slot0,
                                     tasks, task)
            return _fleet_result(traces, aggs, carry, active=active,
                                 intermittent=intermittent, tel_spec=tel_spec,
                                 telemetry_state0=telemetry_state0,
                                 scored=labels is not None, tasks=tasks,
                                 task=task, t=t, c=c)


def _check_windows(shape: tuple, n: int, s: int, har_cfg: HARConfig) -> bool:
    """Whether ``windows`` of ``shape`` are one shared (S, T, C) stream
    (else (N, S, T, C), a stream per node), checked against the harvest's
    (N, S) and the model's (T, C)."""
    if len(shape) not in (3, 4):
        raise ValueError(f"windows must be (S,T,C) or (N,S,T,C), got "
                         f"{shape}")
    shared_stream = len(shape) == 3
    if shared_stream:
        if shape[0] != s:
            raise ValueError(f"windows {shape} vs S={s}")
    elif shape[:2] != (n, s):
        raise ValueError(f"windows {shape} vs (N, S)=({n}, {s})")
    if shape[-2:] != (har_cfg.window, har_cfg.channels):
        raise ValueError(f"windows are (T, C)=({shape[-2]}, {shape[-1]}), "
                         f"the model takes ({har_cfg.window}, "
                         f"{har_cfg.channels})")
    return shared_stream


def _check_generator(generator: torch.Generator | None, dev
                     ) -> torch.Generator:
    """The run's noise generator: ``manual_seed(0)`` on ``dev`` by default;
    one on another device is refused."""
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device != dev:
        raise ValueError(f"generator is on {generator.device}, the run "
                         f"on {dev}")
    return generator


def _model_params(*, signatures, qdnn_params, host_params, gen_params,
                  aac_table, costs, quant_bits, k_max, m_samples,
                  corr_threshold, har_cfg, brownout, intermittent,
                  aux_params, task, dev) -> tuple[dict, bool]:
    """The slot's replicated inputs on ``dev``: the signature bank, the
    quantized D2 (and auxiliary-head) weights, the host and generator
    weights, and the ladder's knobs; and whether every tensor of the
    weights :data:`_WEIGHTS` names is the caller's own (none was copied to
    reach ``dev``), which a captured slot reads where it lies."""
    given = (signatures, host_params, gen_params, aac_table)
    if task is not None and task.per_task_host:
        host_params = tuple(to_device(p, dev) for p in host_params)
    else:
        host_params = to_device(host_params, dev)
    params = dict(
        signatures=to_device(signatures, dev, torch.float32).contiguous(),
        qp=quantize_params(to_device(qdnn_params, dev), quant_bits),
        qa=(None if intermittent is None else
            quantize_params(to_device(aux_params, dev), quant_bits)),
        host_params=host_params,
        gen_params=to_device(gen_params, dev),
        aac_table=None if aac_table is None else to_device(aac_table, dev),
        costs=costs, quant_bits=quant_bits, k_max=k_max,
        m_samples=m_samples, corr_threshold=corr_threshold, har_cfg=har_cfg,
        # strict store-and-execute energy when either lane is on
        strict=brownout is not None or intermittent is not None,
        intermittent=intermittent,
        reserve_uj=brownout.off_uj if brownout is not None else 0.0)
    same = []
    tree_map(lambda a, b: same.append(a is b),
             dict(zip(_WEIGHTS, given)), {k: params[k] for k in _WEIGHTS})
    return params, all(same)


class _SlotInputs(NamedTuple):
    """What the slot loop reads besides the carry: in slot ``si`` the
    windows ``windows[si]`` (a shared stream's (T, C), or (N, T, C)),
    ``harvest[:, si]``, the exogenous ``alive[:, si]`` and the pre-drawn
    ``noise`` (each ``v[si]``; None for another source); in every slot the
    quantized D2 weights ``qp`` and the task lane's (N,) ``scale`` and
    ``tasks`` (None without the lane)."""

    windows: torch.Tensor
    harvest: torch.Tensor
    alive: torch.Tensor
    noise: dict | None
    qp: dict
    scale: torch.Tensor | None
    tasks: torch.Tensor | None


# the weights a captured slot reads where they lie: its key holds their
# addresses, and an in-place update of them is read by the replay
_WEIGHTS = ("signatures", "host_params", "gen_params", "aac_table")
# captures, graph replays (one a slot) and slots run eagerly
_GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager_slots": 0}
# the captured slot loops by key, least recently used first
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPHS_KEPT = 8


def fleet_graph_counts() -> dict:
    """How the fleet's slot loop ran in this process: ``captures`` (keys
    whose slots were captured as CUDA graphs), ``replays`` (graph
    launches, one a slot) and ``eager_slots`` (slots run eagerly: on a
    device that is not CUDA, on the paths that stay eager, and in the call
    that precedes each capture)."""
    return dict(_GRAPH_COUNTS)


def _slot(si: int, inp: _SlotInputs, carry: FleetCarry, *, draw, blocks,
          host_idx, params: dict, slot0: int, lanes: dict):
    """Slot ``si`` of the loop: the noise, every node block's
    :func:`_slot_body`, then :func:`_slot_carry`; returns ``(carry,
    out_t)``.  ``draw()`` is a generator's draw (None for the other
    sources); ``lanes`` the keywords of :func:`_slot_carry`."""
    n = inp.harvest.shape[0]
    with obs_trace.span("fleet.noise"):
        win_t = inp.windows[si]
        if win_t.ndim == 2:                                 # a shared stream
            win_t = win_t.expand((n,) + tuple(win_t.shape)).contiguous()
        if inp.noise is not None:
            nz, next_keys = {k: v[si] for k, v in inp.noise.items()}, None
        elif carry.keys is not None:
            nz, next_keys = draw_slot_noise_keyed(carry.keys,
                                                  *win_t.shape[-2:])
        else:
            nz, next_keys = draw(), None
    harv_t = inp.harvest[:, si]
    body = dict(params, qp=inp.qp)
    parts = [_slot_body(
        tree_map(lambda x: x[sl], carry.node),
        tree_map(lambda x: x[sl], carry.intermittent), win_t[sl],
        harv_t[sl], {k: v[sl] for k, v in nz.items()}, slot0 + si,
        None if inp.scale is None else inp.scale[sl], idx, **body)
        for sl, idx in zip(blocks, host_idx)]
    with obs_trace.span("fleet.carry"):
        return _slot_carry(carry, parts, next_keys, harv_t,
                           inp.alive[:, si], tasks=inp.tasks, **lanes)


def _write_row(traces: dict, si: int, out_t: dict) -> None:
    """Slot ``si``'s emitted traces into row ``si`` of the (S, N, ...)
    ``traces``."""
    copy_leaves({k: traces[k][si] for k in out_t}, out_t)


def _run_eager(step, inp: _SlotInputs, carry: FleetCarry, slot0: int):
    """The slot loop run eagerly, ``step`` (:func:`_slot`) slot by slot:
    the (S, N, ...) traces written row by row, ``preds`` included, and the
    carry after the last slot."""
    s = inp.harvest.shape[1]
    inp = inp._replace(windows=inp.windows.contiguous())
    traces = None
    for si in range(s):
        with obs_trace.span("fleet.slot", {"slot": slot0 + si}):
            carry, out_t = step(si, inp, carry)
            if traces is None:
                traces = {k: v.new_empty((s,) + tuple(v.shape))
                          for k, v in out_t.items()}
            _write_row(traces, si, out_t)
    with obs_trace.span("fleet.aggregates"):
        traces["preds"] = torch.argmax(traces["logits"], dim=-1)
    return traces, carry


def _wide(inp: _SlotInputs) -> _SlotInputs:
    """``inp`` with its windows as (S, N, T, C): a shared stream expanded
    over the nodes (a view)."""
    w = inp.windows
    if w.ndim == 4:
        return inp
    n = inp.harvest.shape[0]
    return inp._replace(windows=w[:, None].expand(
        (w.shape[0], n) + tuple(w.shape[1:])))


class _FleetGraphs:
    """The CUDA graphs of one fleet key: one a slot position of the call,
    captured in order on one private memory pool and replayed in that
    order.  Graph ``si`` reads its slot from the input buffers (the windows
    as (S, N, T, C)), writes row ``si`` of the (S, N, ...) trace buffers
    and then the carry back into the carry buffers; the last also takes
    ``preds``.  The caller's inputs are copied into the buffers and it
    gets clones, so every result it holds stays its own."""

    def __init__(self, step, inp: _SlotInputs, carry: FleetCarry,
                 traces: dict, stream) -> None:
        def buffer(x):
            return torch.empty_like(x, memory_format=torch.contiguous_format)

        self.inp = tree_map(buffer, _wide(inp))
        self.carry = tree_map(buffer, carry)
        self.traces = {k: buffer(v) for k, v in traces.items()
                       if k != "preds"}
        pool = torch.cuda.graph_pool_handle()
        s = inp.harvest.shape[1]
        self.graphs = []
        for si in range(s):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=stream):
                new, out_t = step(si, self.inp, self.carry)
                # the row first: it may hold the carry's entering flags
                _write_row(self.traces, si, out_t)
                copy_leaves(self.carry, new)
                if si == s - 1:
                    self.preds = torch.argmax(self.traces["logits"], dim=-1)
            self.graphs.append(g)

    def run(self, inp: _SlotInputs, carry: FleetCarry, slot0: int):
        copy_leaves({"inp": self.inp, "carry": self.carry},
                    {"inp": _wide(inp), "carry": carry})
        for si, g in enumerate(self.graphs):
            with obs_trace.span("fleet.slot", {"slot": slot0 + si}):
                g.replay()
        _GRAPH_COUNTS["replays"] += len(self.graphs)
        with obs_trace.span("fleet.aggregates"):
            out = clone({"traces": dict(self.traces, preds=self.preds),
                         "carry": self.carry})
        return out["traces"], out["carry"]


def _run_slots(windows, harvest, exo_alive, carry: FleetCarry, *, noise,
               draw, params: dict, own_weights: bool, tasks, task, brownout,
               intermittent, tel_spec, active: frozenset, slot0: int,
               node_block: int | None):
    """The slot loop over the nodes one device holds: ``windows`` the
    (S, T, C) shared stream or (S, N, T, C) streams (any strides),
    ``harvest`` and ``exo_alive`` (N, S), ``carry`` the state entering the
    first slot; the noise pre-drawn (``noise``, (S, N, ...)), from the
    carried keys, or from a generator (``draw()``, one slot's batch).
    Returns the (S, N) traces, ``preds`` included, and the carry after the
    last slot.

    On a CUDA device the first call of a key runs the loop eagerly on a
    side stream, then captures it (:class:`_FleetGraphs`); later calls
    replay the graphs.  The key is the device, the node block, the noise
    source, the shapes and dtypes of the inputs and the carry, the
    address, shape, dtype and strides of every weight :data:`_WEIGHTS`
    names, the ladder's knobs, the lanes and their configs, and the TF32
    switches.  The loop runs eagerly elsewhere, inside a capture of the
    caller's, and wherever a capture would bake in a value of one call: a
    generator's draws, per-task host weights (their node indices), the
    intermittent lane (its global slot index), weights copied to reach
    the device (a new address each call)."""
    n, s = harvest.shape
    dev = harvest.device
    block = n if node_block is None else max(1, min(node_block, n))
    blocks = [slice(lo, lo + block) for lo in range(0, n, block)]
    # the task lane's per-node scale, made once per run
    scale = (None if task is None else torch.tensor(
        task.cost_scale, dtype=torch.float32, device=dev)[tasks.long()])
    host_idx = [None] * len(blocks)
    if task is not None and task.per_task_host:
        host_idx = [[torch.nonzero(tasks[sl] == k).flatten()
                     for k in range(task.n_tasks)] for sl in blocks]
    lanes = dict(brownout=brownout, intermittent=intermittent,
                 tel_spec=tel_spec, active=active,
                 keep_fields=[ln.carry_field for ln in FLEET_LANES
                              if ln.freeze == "keep"])
    inp = _SlotInputs(windows, harvest, exo_alive, noise, params["qp"], scale,
                      tasks)
    step = functools.partial(_slot, draw=draw, blocks=blocks,
                             host_idx=host_idx, params=params, slot0=slot0,
                             lanes=lanes)
    if (dev.type != "cuda" or torch.cuda.is_current_stream_capturing()
            or draw is not None or host_idx[0] is not None
            or intermittent is not None or not own_weights):
        _GRAPH_COUNTS["eager_slots"] += s
        return _run_eager(step, inp, carry, slot0)
    # the configs by value: one read from JSON may hold a list
    knobs = repr(([(k, v) for k, v in params.items()
                   if k not in _WEIGHTS + ("qp", "qa")], brownout, task))
    key = (dev, block, "noise" if noise is not None else "keys",
           layout(inp, carry),
           layout(*(params[k] for k in _WEIGHTS), addresses=True), knobs,
           tel_spec, active, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    graphs = _GRAPHS.get(key)
    if graphs is not None:
        _GRAPHS.move_to_end(key)
        return graphs.run(inp, carry, slot0)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            result = _run_eager(step, inp, carry, slot0)
        _GRAPH_COUNTS["eager_slots"] += s
        _GRAPHS[key] = _FleetGraphs(step, inp, carry, result[0], side)
        torch.cuda.current_stream().wait_stream(side)
    compile_event("serving.fleet_graph", key)
    _GRAPH_COUNTS["captures"] += 1
    while len(_GRAPHS) > _GRAPHS_KEPT:
        _GRAPHS.popitem(last=False)
    return result


def _slot_carry(carry: FleetCarry, parts: list, next_keys, harv_t, alive_t,
                *, brownout, intermittent, tel_spec, active: frozenset,
                tasks, keep_fields: list):
    """The carry after one slot from its node blocks' ``parts``: the blocks
    joined, the 'keep' lanes frozen where a node did not run, the
    brown-out trickle and hysteresis, the slot's emitted traces ``out_t``
    and the telemetry lanes.  Returns ``(carry, out_t)``."""
    n = alive_t.shape[0]
    browned = carry.brownout
    # a node runs when its trace says so and its supercap allows
    alive_eff = alive_t & ~browned if brownout is not None else alive_t
    new = carry._replace(
        node=tree_map(lambda *xs: torch.cat(xs), *[p[0] for p in parts]),
        keys=next_keys,
        intermittent=tree_map(lambda *xs: torch.cat(xs),
                               *[p[1] for p in parts]))
    trace = {k: torch.cat([p[2][k] for p in parts]) for k in parts[0][2]}

    # every 'keep' lane freezes through dead and browned-out slots
    def keep(new_x, old_x):
        a = alive_eff.reshape((n,) + (1,) * (new_x.ndim - 1))
        return torch.where(a, new_x, old_x)

    new = new._replace(**{f: tree_map(keep, getattr(new, f),
                                       getattr(carry, f))
                          for f in keep_fields})
    node = new.node
    next_browned = browned
    if brownout is not None:
        # the brown-out lane's trickle: a browned-out (yet exogenously
        # present) node's supercap still integrates its income
        old = carry.node.stored_uj
        trickle = supercap_step(old, harv_t, 0.0)
        stored = torch.where(alive_eff, node.stored_uj,
                             torch.where(alive_t, trickle, old))
        node = node._replace(stored_uj=stored)
        # hysteresis on the post-slot charge; the flag freezes through
        # exogenously dead slots
        next_browned = torch.where(
            alive_t, torch.where(browned, stored < brownout.restart_uj,
                                 stored < brownout.off_uj), browned)
    out_t = {
        "decisions": torch.where(alive_eff, trace["decisions"], DEFER),
        "payload_bytes": torch.where(alive_eff, trace["payload_bytes"], 0.0),
        "stored_uj": node.stored_uj,
        "k_trace": torch.where(alive_eff, trace["k_trace"], 0),
        "logits": torch.where(alive_eff[:, None], trace["logits"], 0.0),
        "alive": alive_eff,
        "brownout": browned,
        "bo_event": next_browned & ~browned,
    }
    if intermittent is not None:
        # a node that did not run emitted nothing; the other it_* fields
        # mean something only where it_emit > 0
        out_t.update({k: trace[k] for k in ("it_label", "it_conf",
                                             "it_src", "it_stage")})
        out_t["it_emit"] = torch.where(alive_eff, trace["it_emit"], 0)
    # telemetry: a fleet-level accumulator, never frozen per node
    carry = new._replace(
        node=node, brownout=next_browned,
        telemetry=None if tel_spec is None else _update_fleet_lanes(
            tel_spec, carry.telemetry, out_t, alive_t, active, tasks))
    return carry, out_t


def _fleet_result(traces: dict, aggs: dict, carry: FleetCarry, *,
                  active: frozenset, intermittent, tel_spec,
                  telemetry_state0, scored: bool, tasks, task, t: int,
                  c: int) -> dict:
    """The engine's result dict from the whole fleet's traces, aggregates
    and final carry (``scored``: labels were given)."""
    dev = traces["decisions"].device
    out = {k: traces[k] for k in fleet_trace_keys(active)}
    out.update(aggs)
    out.update(
        completed_frac=aggs["completed"] / torch.clamp(aggs["alive_slots"],
                                                       min=1),
        raw_bytes_per_window=torch.tensor(
            float(raw_payload_bytes(t)) * c, dtype=torch.float32, device=dev),
        final_state=carry.node, final_brownout=carry.brownout)
    if carry.keys is not None:
        out["final_keys"] = carry.keys
    if intermittent is not None:
        out["final_intermittent"] = carry.intermittent
    if tel_spec is not None:
        tel0 = (None if telemetry_state0 is None
                else to_device(telemetry_state0, dev, torch.int32))
        out["telemetry"] = metrics_merge(tel_spec, tel0, carry.telemetry)
        out["telemetry_spec"] = tel_spec
    if scored:
        out["fleet_accuracy"] = aggs["correct"] / torch.clamp(
            aggs["completed"], min=1)
    if task is not None:
        out["task_names"] = task.names
        out["tasks"] = tasks
        if scored:
            out["accuracy_by_task"] = aggs["correct_by_task"] / torch.clamp(
                aggs["completed_by_task"], min=1)
    return out


def _tile(x, n: int, lo: int, hi: int, dev, dtype=None, dim: int = 0,
          fill=None):
    """Rows ``[lo, hi)`` of the padded fleet along ``dim`` of ``x`` (a
    tensor, numpy array or NamedTuple of them with ``n`` rows there), moved
    to ``dev``: the real rows, then the padding rows of ``fill`` (same
    structure, ``hi - max(lo, n)`` rows; zeros when ``None``)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tile(v, n, lo, hi, dev, dtype, dim,
                               None if fill is None else getattr(fill, f))
                         for f, v in zip(x._fields, x)))
    x = _as_array(x)
    real = to_device(x[(slice(None),) * dim + (slice(min(lo, n),
                                                     min(hi, n)),)],
                     dev, dtype)
    short = (hi - lo) - real.shape[dim]
    if not short:
        return real
    if fill is None:
        shape = list(real.shape)
        shape[dim] = short
        fill = torch.zeros(shape, dtype=real.dtype, device=dev)
    return torch.cat([real, to_device(fill, dev, real.dtype)], dim=dim)


def _gather_nodes(x, shard: NodeShard, n: int, dim: int = 0):
    """Every rank's tile of ``x`` (a tensor or NamedTuple of them, node axis
    ``dim``), gathered in the global order with the padding cut off."""
    if x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_gather_nodes(v, shard, n, dim) for v in x))
    return all_gather_tiles(x, shard, dim).narrow(dim, 0, n)


def _reduce_aggregates(aggs: dict, shard: NodeShard) -> dict:
    """The aggregates summed over the ranks: the integer counts in one
    int64 all-reduce (exact), the float32 ``bytes_on_wire`` in another."""
    ints = [k for k, v in aggs.items() if not v.is_floating_point()]
    floats = [k for k in aggs if k not in ints]
    out = {}
    for keys, dtype in ((ints, torch.int64), (floats, torch.float32)):
        if not keys:
            continue
        flat = all_reduce_sum(torch.cat([aggs[k].reshape(-1).to(dtype)
                                         for k in keys]), shard)
        at = 0
        for k in keys:
            size = aggs[k].numel()
            out[k] = flat[at:at + size].reshape(aggs[k].shape).to(
                aggs[k].dtype)
            at += size
    return out


def _default_mesh(dev: torch.device):
    """The reference's default: a 1-D ("data",) mesh over every rank of the
    initialized default group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "the sharded fleet needs an initialized process group (or a "
            "mesh): call torch.distributed.init_process_group first")
    return make_mesh((dist.get_world_size(),), ("data",),
                     device_type=dev.type)


def seeker_fleet_simulate_sharded(
        windows, harvest, *, signatures, qdnn_params, host_params,
        gen_params, har_cfg: HARConfig, mesh=None,
        aac_table: AACTable | None = None, costs: EnergyCosts | None = None,
        generator: torch.Generator | None = None, noise: dict | None = None,
        node_keys=None, quant_bits: int = 16, k_max: int = 12,
        m_samples: int = 20,
        corr_threshold: float = 0.95, predictor_window: int = 8,
        initial_uj: float = 50.0, state0: SeekerNodeState | None = None,
        labels=None, alive=None, brownout: BrownoutConfig | None = None,
        brownout_state0=None, node_block: int | None = None,
        intermittent: IntermittentConfig | None = None,
        intermittent_state0: IntermittentState | None = None,
        aux_params: dict | None = None, slot0: int = 0, telemetry=None,
        telemetry_state0: dict | None = None, tasks=None,
        task: TaskLaneConfig | None = None, device=None):
    """:func:`seeker_fleet_simulate` with the node axis split over the ranks
    of a ``torch.distributed`` device mesh.

    SPMD: every rank of ``mesh`` calls this with the same global inputs.
    The node axis splits over the mesh dims the ``"nodes"`` rule names
    (:data:`repro_torch.sharding.FLEET_RULES`: ("pod", "data"), pod-major);
    a rank moves only its tile of every per-node input to ``device`` and
    runs the single-device slot loop on it, and the signature bank and
    every weight tree are replicated.  After the last slot the aggregates
    and the telemetry lanes are summed over the ranks
    (:func:`repro_torch.obs.metrics_psum`), and the traces and final
    carries are gathered, so every rank returns the whole fleet's result.

    A fleet whose N is not a multiple of the mesh quantum is padded with
    inert nodes: zero windows and harvest, permanently dead, their
    brown-out flag held awake, task 0 and an idle intermittent lane; a
    padding mask takes them out of every aggregate, and they are cut from
    every returned trace.

    The noise does not depend on the layout: ``noise=`` (S, N, ...) is cut
    to each rank's tile (padding rows zero); with ``node_keys`` each rank
    hashes only its tile's keys (padding nodes get inert zero keys, which
    stay frozen since those nodes never run); and with a ``generator``
    every rank draws the whole fleet's slot batch
    (:func:`draw_slot_noise`) from its own generator, seeded alike on
    every rank, and keeps its tile.  So a sharded run equals the
    single-device engine's with the same noise source for any world size:
    integer and energy traces exactly; the logits exactly when the node
    blocks have the same shape (``node_block`` at most the tile), else to
    the last bits of float32.

    Args (beyond :func:`seeker_fleet_simulate`'s):
        mesh: a ``DeviceMesh`` whose dims are named from ("pod", "data");
            default, a ("data",) mesh over the default group.  Anything
            else raises ``ValueError``.

    Returns :func:`seeker_fleet_simulate`'s dict for the whole fleet, plus
    ``padded_nodes`` (the inert nodes added) and ``node_axes`` (the mesh
    dims the node axis split over).
    """
    n, s = tuple(_as_array(harvest).shape)
    with obs_trace.span("fleet.step", {"nodes": n, "slots": s}):
        with obs_trace.span("fleet.prepare"):
            dev = resolve_device(device)
            _check_sources(generator, noise, node_keys)
            shard = node_shard(mesh if mesh is not None
                               else _default_mesh(dev))
            costs = costs or EnergyCosts()
            win = _as_array(windows)
            shared_stream = _check_windows(tuple(win.shape), n, s, har_cfg)
            t, c = win.shape[-2:]
            # this rank's tile of every per-node input and of the carried
            # whole-fleet state
            with obs_trace.span("fleet.tile"):
                pad, lo, hi = shard.bounds(n)
                rows = functools.partial(_tile, n=n, lo=lo, hi=hi, dev=dev)
                mask = torch.arange(lo, hi, device=dev) < n
                if shared_stream:
                    xs_w = to_device(win, dev, torch.float32).contiguous()
                else:
                    xs_w = rows(win, dtype=torch.float32).transpose(0, 1)
                harv = rows(harvest, dtype=torch.float32)
                alive_g = _check_alive(alive, n, s)
                # padding nodes are permanently dead: their ladder never runs
                exo_alive = (mask[:, None].expand(hi - lo, s).clone()
                             if alive_g is None
                             else rows(alive_g, dtype=torch.bool))
                labels_g, per_node_labels = _labels_layout(labels, s, n,
                                                           shared_stream)
                if labels_g is None:
                    labels_t = None
                elif per_node_labels:
                    labels_t = rows(labels_g, dtype=torch.int64, dim=1)
                else:
                    labels_t = to_device(labels_g, dev, torch.int64)
                filler = fleet_node_init(max(hi - max(lo, n), 0),
                                         predictor_window, initial_uj, dev)
                if state0 is None:
                    state = fleet_node_init(hi - lo, predictor_window,
                                            initial_uj, dev)
                else:
                    lead = _as_array(state0.stored_uj).shape[0]
                    if lead != n:
                        raise ValueError(f"state0 is stacked for {lead} "
                                         f"nodes, fleet has {n}")
                    state = rows(state0, fill=filler)
                if brownout_state0 is not None:
                    b0 = _as_array(brownout_state0)
                    if tuple(b0.shape) != (n,):
                        raise ValueError(f"brownout_state0 must be "
                                         f"(N,)=({n},) bool, got "
                                         f"{tuple(b0.shape)}")
                    browned0 = rows(b0, dtype=torch.bool)
                else:
                    # boot-time hysteresis on the real nodes; padding held
                    # awake
                    browned0 = _resolve_brownout0(None, state, brownout,
                                                  hi - lo) & mask
                _validate_intermittent_args(intermittent, intermittent_state0,
                                            aux_params, n)
                tasks, task = _resolve_tasks(tasks, task, n, dev)
                host_params = _resolve_task_host(task, host_params)
                # padding: task 0
                tasks_t = None if tasks is None else rows(tasks)
                tel_spec = _resolve_telemetry(telemetry, intermittent, task)
                active = _active_lanes(intermittent, task, brownout)
                it = None
                if intermittent is not None:
                    it_fill = intermittent_fleet_init(
                        filler.stored_uj.shape[0], har_cfg, dev)
                    it = (intermittent_fleet_init(hi - lo, har_cfg, dev)
                          if intermittent_state0 is None
                          else rows(intermittent_state0, fill=it_fill))
                keys0 = draw = None
                if noise is not None:
                    noise = _check_noise(
                        noise, s, n, t, c,
                        functools.partial(rows, dtype=torch.float32, dim=1))
                elif node_keys is not None:
                    # this tile's keys; padding nodes get inert zero keys
                    keys0 = _check_keys(node_keys, n, functools.partial(
                        rows, dtype=torch.int64))
                else:
                    generator = _check_generator(generator, dev)

                    def draw():
                        # the whole fleet's batch, from the same stream on
                        # every rank
                        return {k: rows(v) for k, v in draw_slot_noise(
                            generator, n, t, c).items()}
            carry = FleetCarry(
                node=state, keys=keys0, intermittent=it, brownout=browned0,
                telemetry=(None if tel_spec is None
                           else metrics_init(tel_spec, dev)))
            params, own_weights = _model_params(
                signatures=signatures, qdnn_params=qdnn_params,
                host_params=host_params, gen_params=gen_params,
                aac_table=aac_table, costs=costs, quant_bits=quant_bits,
                k_max=k_max, m_samples=m_samples,
                corr_threshold=corr_threshold, har_cfg=har_cfg,
                brownout=brownout, intermittent=intermittent,
                aux_params=aux_params, task=task, dev=dev)
        traces, carry = _run_slots(
            xs_w, harv, exo_alive, carry, noise=noise, draw=draw,
            params=params, own_weights=own_weights, tasks=tasks_t, task=task,
            brownout=brownout, intermittent=intermittent, tel_spec=tel_spec,
            active=active, slot0=slot0, node_block=node_block)
        with obs_trace.span("fleet.aggregates"):
            aggs = _fleet_aggregates(
                traces, exo_alive.T, labels_t, per_node_labels, intermittent,
                slot0, tasks_t, task, mask=mask)
            # the collectives: every rank's counts summed, every tile's
            # traces and carry gathered
            with obs_trace.span("fleet.collect"):
                aggs = _reduce_aggregates(aggs, shard)
                gathered = {k: _gather_nodes(traces[k], shard, n, dim=1)
                            for k in fleet_trace_keys(active) if k != "preds"}
                carry = FleetCarry(
                    node=_gather_nodes(carry.node, shard, n),
                    keys=_gather_nodes(carry.keys, shard, n),
                    brownout=_gather_nodes(carry.brownout, shard, n),
                    intermittent=_gather_nodes(carry.intermittent, shard, n),
                    telemetry=None if tel_spec is None else metrics_psum(
                        tel_spec, carry.telemetry, shard.group))
            gathered["preds"] = torch.argmax(gathered["logits"], dim=-1)
            out = _fleet_result(gathered, aggs, carry, active=active,
                                intermittent=intermittent, tel_spec=tel_spec,
                                telemetry_state0=telemetry_state0,
                                scored=labels_t is not None, tasks=tasks,
                                task=task, t=t, c=c)
            out.update(padded_nodes=pad, node_axes=shard.axes)
            return out


def seeker_fleet_simulate_streamed(
        windows, harvest, *, chunk: int,
        generator: torch.Generator | None = None, noise: dict | None = None,
        node_keys=None,
        state0: SeekerNodeState | None = None, labels=None, alive=None,
        brownout: BrownoutConfig | None = None, brownout_state0=None,
        intermittent: IntermittentConfig | None = None,
        intermittent_state0: IntermittentState | None = None,
        aux_params: dict | None = None, telemetry=None,
        telemetry_state0: dict | None = None, tasks=None,
        task: TaskLaneConfig | None = None, mesh=None, device=None, **kw):
    """Run the fleet in segments of ``chunk`` slots instead of holding the
    whole window stream on the device.

    Each segment runs through :func:`seeker_fleet_simulate` with the
    previous segment's ``final_state``, ``final_brownout``,
    ``final_intermittent`` (at its global ``slot0``), ``final_keys`` and
    ``telemetry``, so
    the chain is bitwise one long run, while only one (N, chunk, T, C)
    segment of windows is on the device.

    Args (beyond the engine's; ``kw`` passes the model and its knobs on):
        windows: the stream source: an array ((S, T, C) shared or
            (N, S, T, C) per node; the driver slices it) or a callable
            ``windows(start, stop)`` returning one segment.
        chunk: slots per segment (the last one may be shorter).
        generator: one ``torch.Generator`` handed from segment to segment,
            so the draws go on slot by slot as in one long run (default
            ``manual_seed(0)`` on ``device``); or ``noise``, pre-drawn
            (S, N, ...) tensors sliced per segment; or ``node_keys``, the
            per-node keys, chained from segment to segment through each
            one's ``final_keys`` (returned as ``final_keys``).
        mesh: a ``DeviceMesh``: every segment runs through
            :func:`seeker_fleet_simulate_sharded` on it (every rank calls
            the driver with the same global inputs, and a ``generator``
            seeded alike on every rank); ``None`` is the single-device
            engine.

    Returns the engine's dict: traces concatenated over time, the counters
    the lane registry names summed exactly (``bytes_on_wire_exact`` in
    int64), ``bytes_on_wire`` summed per segment, the label-scored counts
    (``correct``, ``it_correct_*``, ``correct_by_task``) rescored over the
    concatenated traces (a segment cannot see the labels of windows caught
    before it), the fractions recomputed, and ``n_chunks``; with a ``mesh``
    also ``padded_nodes`` and ``node_axes``.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    _check_sources(generator, noise, node_keys)
    dev = resolve_device(device)
    harvest = to_device(harvest, dev, torch.float32)
    n, s = harvest.shape
    if s < 1:
        raise ValueError(f"cannot stream an empty deployment: harvest is "
                         f"(N, S)=({n}, {s}); S must be >= 1 slot")
    if callable(windows):
        window_fn = windows
    else:
        arr = windows if isinstance(windows, torch.Tensor) else np.asarray(
            windows)
        if arr.ndim == 3:
            window_fn = lambda a, b: arr[a:b]                 # noqa: E731
        else:
            window_fn = lambda a, b: arr[:, a:b]              # noqa: E731
    labels_full = None if labels is None else to_device(labels, dev,
                                                        torch.int64)
    alive_full = None if alive is None else _resolve_alive(alive, n, s, dev)
    tasks, task = _resolve_tasks(tasks, task, n, dev)
    tel_spec = _resolve_telemetry(telemetry, intermittent, task)
    if noise is None and generator is None and node_keys is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    engine = (seeker_fleet_simulate if mesh is None else functools.partial(
        seeker_fleet_simulate_sharded, mesh=mesh))
    active = _active_lanes(intermittent, task, brownout)
    trace_keys = fleet_trace_keys(active)
    counter_keys = fleet_counter_keys(active)

    state, browned, it_state = state0, brownout_state0, intermittent_state0
    keys = node_keys
    tel_state = telemetry_state0
    parts, counters, res = [], {}, None
    bytes_on_wire = torch.zeros((), dtype=torch.float32, device=dev)
    bytes_exact = torch.zeros((), dtype=torch.int64, device=dev)
    for start in range(0, s, chunk):
        stop = min(start + chunk, s)
        seg = dict(kw, brownout=brownout, intermittent=intermittent,
                   aux_params=aux_params, tasks=tasks, task=task,
                   telemetry=tel_spec, telemetry_state0=tel_state,
                   state0=state, brownout_state0=browned,
                   intermittent_state0=it_state, slot0=start, device=dev)
        if noise is not None:
            seg["noise"] = {k: v[start:stop] for k, v in noise.items()}
        elif keys is not None:
            seg["node_keys"] = keys
        else:
            seg["generator"] = generator
        if labels_full is not None:
            seg["labels"] = labels_full[start:stop]
        if alive_full is not None:
            seg["alive"] = alive_full[:, start:stop]
        with obs_trace.span("fleet.segment", {"start": start, "stop": stop}):
            res = engine(window_fn(start, stop), harvest[:, start:stop],
                         **seg)
        state, browned = res["final_state"], res["final_brownout"]
        it_state = res.get("final_intermittent")
        keys = res.get("final_keys")
        tel_state = res.get("telemetry")
        parts.append({k: res[k] for k in trace_keys})
        for k in counter_keys:
            if k in res:
                counters[k] = counters.get(k, 0) + res[k]
        bytes_on_wire = bytes_on_wire + res["bytes_on_wire"]
        bytes_exact = bytes_exact + res["bytes_on_wire_exact"]

    out = {k: torch.cat([p[k] for p in parts]) for k in trace_keys}
    out.update(counters)
    out.update(
        bytes_on_wire=bytes_on_wire, bytes_on_wire_exact=bytes_exact,
        completed_frac=counters["completed"] / torch.clamp(
            counters["alive_slots"], min=1),
        raw_bytes_per_window=res["raw_bytes_per_window"],
        final_state=state, final_brownout=browned, n_chunks=-(-s // chunk))
    if keys is not None:
        out["final_keys"] = keys
    if intermittent is not None:
        out["final_intermittent"] = it_state
    if tel_spec is not None:
        out["telemetry"] = tel_state
        out["telemetry_spec"] = tel_spec
    if task is not None:
        out["task_names"] = task.names
        out["tasks"] = tasks
    if labels_full is not None:
        out.update(_label_scores(out, labels_full, labels_full.ndim == 2,
                                 intermittent, 0, tasks, task))
        out["fleet_accuracy"] = out["correct"] / torch.clamp(
            counters["completed"], min=1)
        if task is not None:
            out["accuracy_by_task"] = out["correct_by_task"] / torch.clamp(
                counters["completed_by_task"], min=1)
    if mesh is not None:
        out["padded_nodes"] = res["padded_nodes"]
        out["node_axes"] = res["node_axes"]
    return out


def wire_bytes_exact(res: dict) -> int:
    """The exact total bytes the fleet put on the wire, as a Python int
    (``bytes_on_wire`` is float32 and only approximate past 2**24)."""
    return int(res["bytes_on_wire_exact"])
