"""Seeker edge-host serving: the paper's decision flow (Fig. 8) for a
batch of nodes.

PyTorch counterpart of the bare slot of :mod:`repro.serving.edge_host`.
:func:`seeker_sensor_step_given_corr` and :func:`seeker_host_step` are
written batched over a leading node axis — the JAX fleet's ``vmap`` over
nodes written out — and take their random draws as tensors:

* the sensor step takes ``u`` (N, T), the D4 Gumbel uniforms
  (:func:`seeker_sensor_step` correlates the windows with the signature
  bank itself; :func:`seeker_sensor_step_given_corr` takes the
  correlations);
* the host step takes ``dirs`` (N, C, T, 2), ``radii_u`` (N, C, T, 1) and
  ``latent`` (N, 16), the cluster- and sampling-recovery draws.

Every branch (D2's quantized DNN, D3's cluster coresets, D4's sampling
coreset and both host recoveries) runs for every node every slot; the
decision only selects among the results, as in the JAX engine.

:func:`seeker_simulate_reference` is the per-sensor oracle: a Python loop
over sensors and slots of the sensor and host steps on one node, which
:func:`seeker_simulate` (the fleet engine) reproduces given the same noise.

The intermittent lane (:func:`intermittent_lane_step`, codes D6/D7/D8) is
batched the same way: its three inference stages run for every node every
slot, and each node's progress selects among them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.aac import AACTable, select_k
from ..core.coreset import (ClusterCoreset, SamplingCoreset,
                            channel_cluster_coresets, cluster_payload_bytes,
                            importance_coreset, raw_payload_bytes,
                            sampling_payload_bytes)
from ..core.decision import (D0_MEMO, D2_DNN_QUANT, D3_CLUSTER, D4_SAMPLING,
                             D6_PARTIAL, D7_EARLY_EXIT, D8_STAGED_FULL, DEFER,
                             IntermittentConfig, choose_decision)
from ..core.energy import (EnergyCosts, PredictorState, predictor_forecast,
                           predictor_init, predictor_update, supercap_step,
                           supercap_step_direct)
from ..core.recovery import (GeneratorParams, recover_cluster_window,
                             recover_sampling_window)
from ..kernels.ops import signature_corr_op
from ..models.har import (HARConfig, har_act_buffer, har_apply,
                          har_apply_aux, har_apply_quantized_nodes,
                          har_apply_stage, quantize_params)
from ..obs import trace as obs_trace
from ..sharding import all_gather_tiles, all_reduce_sum, exchange, node_shard

__all__ = ["SeekerNodeState", "SensorStepOut", "seeker_node_init",
           "seeker_sensor_step", "seeker_sensor_step_given_corr",
           "seeker_host_step", "seeker_simulate",
           "seeker_simulate_reference", "IntermittentState",
           "intermittent_node_init", "intermittent_fleet_init",
           "IntermittentLaneOut",
           "intermittent_lane_step", "fleet_serve_step",
           "edge_host_serve_step", "WirePayload",
           "encode_wire_coresets", "decode_wire_coresets",
           "wire_payload_nbytes", "wire_payload_to_bytes",
           "wire_payload_from_bytes", "WireSamplePayload",
           "encode_wire_samples", "decode_wire_samples",
           "wire_sample_nbytes"]


class SeekerNodeState(NamedTuple):
    stored_uj: torch.Tensor          # supercap charge
    predictor: PredictorState
    prev_label: torch.Tensor         # temporal continuity for AAC


def seeker_node_init(predictor_window: int = 8, initial_uj: float = 50.0,
                     device=None) -> SeekerNodeState:
    return SeekerNodeState(
        stored_uj=torch.tensor(initial_uj, dtype=torch.float32,
                               device=device),
        predictor=predictor_init(predictor_window, device=device),
        prev_label=torch.zeros((), dtype=torch.int32, device=device))


class SensorStepOut(NamedTuple):
    decision: torch.Tensor           # (N,) int32
    label_or_neg: torch.Tensor       # (N,) int32: >= 0 for D0/D2 results
    logits: torch.Tensor             # (N, L) on-node logits (D2) or zeros
    coreset_centers: torch.Tensor    # (N, C, k_max, 2)
    coreset_radii: torch.Tensor      # (N, C, k_max)
    coreset_counts: torch.Tensor     # (N, C, k_max)
    coreset_k: torch.Tensor          # (N,) int32 — AAC-selected k
    samp_idx: torch.Tensor           # (N, m) int32 — D4 payload
    samp_vals: torch.Tensor          # (N, m, C)
    samp_mean: torch.Tensor          # (N, C)
    samp_var: torch.Tensor           # (N, C)
    payload_bytes: torch.Tensor      # (N,) float32
    state: SeekerNodeState


def seeker_sensor_step(window: torch.Tensor, state: SeekerNodeState,
                       harvested_uj: torch.Tensor, u: torch.Tensor, *,
                       signatures: torch.Tensor, qp: dict,
                       aac_table: AACTable | None, costs: EnergyCosts,
                       k_max: int = 12, m_samples: int = 20,
                       quant_bits: int = 16,
                       corr_threshold: float = 0.95) -> SensorStepOut:
    """One sensing slot on N nodes (paper Fig. 8, every branch run):
    ``window`` (N, T, C) is correlated with the (L, T, C) ``signatures``
    in one :func:`signature_corr_op` call, then
    :func:`seeker_sensor_step_given_corr` runs the slot.  ``qp`` is the
    pre-quantized D2 network and ``u`` (N, T) the D4 Gumbel uniforms."""
    corr = signature_corr_op(window, signatures)
    return seeker_sensor_step_given_corr(
        window, state, harvested_uj, corr, u, qp=qp, aac_table=aac_table,
        costs=costs, k_max=k_max, m_samples=m_samples,
        quant_bits=quant_bits, corr_threshold=corr_threshold)


# never evicted: a captured fleet slot (serving/fleet.py) reads it
@functools.lru_cache(maxsize=None)
def _payload_table(m_samples: int, channels: int,
                   device: torch.device) -> torch.Tensor:
    """(6,) float32 payload bytes by decision code up to DEFER (D3's AAC
    bytes are computed per node), made once per sampling size, channel
    count and device; callers only read it."""
    return torch.tensor([
        2.0,                                              # D0: a label
        2.0, 2.0,                                         # D1/D2: a result
        0.0,                                              # D3: AAC (below)
        float(sampling_payload_bytes(m_samples, channels=channels)),
        0.0,                                              # DEFER
    ], dtype=torch.float32, device=device)


def seeker_sensor_step_given_corr(
        window: torch.Tensor, state: SeekerNodeState,
        harvested_uj: torch.Tensor, corr: torch.Tensor, u: torch.Tensor, *,
        qp: dict, aac_table: AACTable | None,
        costs: EnergyCosts, k_max: int = 12, m_samples: int = 20,
        quant_bits: int = 16, corr_threshold: float = 0.95,
        strict_energy: bool = False,
        cost_scale: torch.Tensor | None = None) -> SensorStepOut:
    """One sensing slot on N nodes with the signature correlations
    ``corr`` (N, L) precomputed.  ``qp`` is the pre-quantized D2 network
    (:func:`repro_torch.models.har.quantize_params`), so a fleet run
    quantizes its weights once; ``u`` (N, T) is the D4 Gumbel uniforms.
    ``strict_energy`` switches the ladder to store-and-execute accounting.
    ``cost_scale`` (N,) is the task lane's per-node ladder scale
    (:class:`repro_torch.serving.fleet_lanes.TaskLaneConfig`)."""
    max_corr = corr.amax(dim=-1)
    memo_label = torch.argmax(corr, dim=-1).to(torch.int32)

    predictor = predictor_update(state.predictor, harvested_uj)
    forecast = predictor_forecast(predictor)
    outcome = choose_decision(
        max_corr, state.stored_uj, forecast, costs,
        corr_threshold=corr_threshold,
        harvested_uj=harvested_uj if strict_energy else None,
        cost_scale=cost_scale)
    decision = outcome.decision

    # --- D2: quantized DNN on-node (executed unconditionally, masked out) ---
    logits = har_apply_quantized_nodes(qp, window, quant_bits)
    dnn_label = torch.argmax(logits, dim=-1).to(torch.int32)

    # --- D3: AAC clustering coreset (per channel, as the paper's FIFO) ----
    n = window.shape[0]
    if aac_table is not None:
        k_sel = select_k(aac_table, state.prev_label,
                         state.stored_uj + forecast)
    else:
        k_sel = torch.full((n,), k_max, dtype=torch.int32,
                           device=window.device)
    cs = channel_cluster_coresets(window, k=k_max, iters=4)
    # zero out clusters beyond the AAC-selected k (static k_max buffer)
    keep = torch.arange(k_max, device=window.device)[None, :] < k_sel[:, None]
    centers = torch.where(keep[:, None, :, None], cs.centers, 0.0)
    radii = torch.where(keep[:, None, :], cs.radii, 0.0)
    counts = torch.where(keep[:, None, :], cs.counts, 0)

    # --- D4: importance-sampling coreset ----------------------------------
    sc = importance_coreset(window, m_samples, u)

    # --- bookkeeping --------------------------------------------------------
    c = window.shape[-1]
    bytes_by_decision = _payload_table(m_samples, c, window.device)
    kf = k_sel.to(torch.float32)
    aac_bytes = (kf * 3.0 + torch.ceil(kf / 2.0)) * c
    payload = torch.where(decision == D3_CLUSTER, aac_bytes,
                          bytes_by_decision[decision.long()])

    step = supercap_step_direct if strict_energy else supercap_step
    stored = step(state.stored_uj, harvested_uj, outcome.spend)
    neg = torch.full_like(decision, -1)
    label = torch.where(decision == D0_MEMO, memo_label,
                        torch.where(decision == D2_DNN_QUANT, dnn_label, neg))
    prev = torch.where(label >= 0, label, state.prev_label)
    return SensorStepOut(
        decision=decision, label_or_neg=label,
        logits=torch.where((decision == D2_DNN_QUANT)[:, None], logits, 0.0),
        coreset_centers=centers, coreset_radii=radii, coreset_counts=counts,
        coreset_k=k_sel, samp_idx=sc.indices, samp_vals=sc.values,
        samp_mean=sc.mean, samp_var=sc.var, payload_bytes=payload,
        state=SeekerNodeState(stored_uj=stored, predictor=predictor,
                              prev_label=prev))


def seeker_host_step(out: SensorStepOut, dirs: torch.Tensor,
                     radii_u: torch.Tensor, latent: torch.Tensor, *,
                     host_params: dict, gen_params: GeneratorParams,
                     t: int) -> torch.Tensor:
    """Host side for N nodes: recover each offloaded representation and
    infer (D3/D4); pass on-node results (D0/D2) through as a confident
    one-hot.  Returns (N, n_classes) logits."""
    cs = ClusterCoreset(out.coreset_centers, out.coreset_radii,
                        out.coreset_counts)
    win_cluster = recover_cluster_window(cs, dirs, radii_u, t)
    sc = SamplingCoreset(out.samp_idx, out.samp_vals,
                         torch.ones_like(out.samp_idx, dtype=torch.float32),
                         out.samp_mean, out.samp_var)
    win_sampling = recover_sampling_window(gen_params, sc, latent, t)

    logit_cluster = har_apply(host_params, win_cluster)
    logit_sampling = har_apply(host_params, win_sampling)
    n_cls = logit_cluster.shape[-1]
    # jax.nn.one_hot(-1) is all zeros: mask the labels that are -1
    lab = out.label_or_neg.long()
    onehot = (torch.nn.functional.one_hot(lab.clamp(min=0), n_cls)
              * (lab >= 0)[:, None]).to(torch.float32) * 8.0
    dec = out.decision[:, None]
    return torch.where(dec == D3_CLUSTER, logit_cluster,
                       torch.where(dec == D4_SAMPLING, logit_sampling,
                                   torch.where(dec == DEFER,
                                               torch.zeros_like(logit_cluster),
                                               onehot)))


# ---------------------------------------------------------------------------
# Intermittent-inference lane (decision codes D6/D7/D8)
# ---------------------------------------------------------------------------


class IntermittentState(NamedTuple):
    """Per-node staged-inference progress, the intermittent lane's part of
    the fleet carry.

    ``active``: a staged inference is in flight.  ``stage``: completed
    stages (1..3).  ``acts``: (A,) flat buffer holding the last completed
    stage's output (A = :func:`repro_torch.models.har.har_act_buffer`).
    ``src_slot``: the global slot whose window is in flight; emissions are
    scored against that slot's label."""

    active: torch.Tensor     # () / (N,) bool
    stage: torch.Tensor      # () / (N,) int32
    acts: torch.Tensor       # (A,) / (N, A) float32
    src_slot: torch.Tensor   # () / (N,) int32


def intermittent_node_init(har_cfg: HARConfig,
                           device=None) -> IntermittentState:
    """Idle single-node lane state (nothing in flight)."""
    return IntermittentState(
        active=torch.zeros((), dtype=torch.bool, device=device),
        stage=torch.zeros((), dtype=torch.int32, device=device),
        acts=torch.zeros((har_act_buffer(har_cfg),), dtype=torch.float32,
                         device=device),
        src_slot=torch.zeros((), dtype=torch.int32, device=device))


def intermittent_fleet_init(n_nodes: int, har_cfg: HARConfig,
                            device=None) -> IntermittentState:
    """Stacked idle lane state for ``n_nodes`` (leading node axis)."""
    return IntermittentState(
        active=torch.zeros((n_nodes,), dtype=torch.bool, device=device),
        stage=torch.zeros((n_nodes,), dtype=torch.int32, device=device),
        acts=torch.zeros((n_nodes, har_act_buffer(har_cfg)),
                         dtype=torch.float32, device=device),
        src_slot=torch.zeros((n_nodes,), dtype=torch.int32, device=device))


class IntermittentLaneOut(NamedTuple):
    engaged: torch.Tensor       # (N,) bool: the lane overrode this slot
    decision: torch.Tensor      # (N,) int32: D6/D7/D8 or DEFER
    spend: torch.Tensor         # (N,) float µJ actually consumed
    payload_bytes: torch.Tensor # (N,) float: 3 B early exit, 2 B full
    stored_uj: torch.Tensor     # (N,) post-slot supercap charge
    prev_label: torch.Tensor    # (N,) int32 AAC continuity after the slot
    emit: torch.Tensor          # (N,) int32: 0 none, 1 early exit, 2 full
    emit_label: torch.Tensor    # (N,) int32 (valid where emit > 0)
    emit_conf: torch.Tensor     # (N,) float aux-head max softmax
    emit_src: torch.Tensor      # (N,) int32 source slot of the window
    emit_stage: torch.Tensor    # (N,) int32 depth at emission
    state: IntermittentState


@functools.lru_cache(maxsize=16)
def _stage_costs(costs: EnergyCosts, quant_bits: int,
                 device: torch.device) -> torch.Tensor:
    """:meth:`EnergyCosts.stage_costs` as a float32 tensor on ``device``,
    made once per run configuration."""
    return torch.tensor(costs.stage_costs(quant_bits), dtype=torch.float32,
                        device=device)


def intermittent_lane_step(window: torch.Tensor, state: SeekerNodeState,
                           harvested_uj: torch.Tensor,
                           ladder_decision: torch.Tensor,
                           it: IntermittentState, slot: int, *, qp: dict,
                           qa: dict, har_cfg: HARConfig, costs: EnergyCosts,
                           quant_bits: int, cfg: IntermittentConfig,
                           reserve_uj: float = 0.0,
                           cost_scale: torch.Tensor | None = None
                           ) -> IntermittentLaneOut:
    """One slot of the partial-inference lane for N nodes, after the ladder.

    The lane engages where an inference is in flight (it resumes before new
    work starts) or where the ladder chose DEFER.  Under strict
    store-and-execute accounting (every µJ spent is paid from ``stored +
    harvested`` this slot) it pays the sensing cost, runs as many remaining
    stages as the budget affords (:meth:`EnergyCosts.stage_costs`), then
    emits D8 at full depth with an affordable ``tx_result``, or an early
    exit D7 from the auxiliary head (at least ``cfg.min_exit_stage`` stages
    done, ``aux_head + tx_result`` affordable, confidence at least
    ``cfg.exit_threshold``), or suspends: D6 with progress kept, DEFER when
    nothing was started.  Stages and emissions also leave ``reserve_uj``
    behind (the brown-out threshold).

    ``qp`` and ``qa`` are the backbone and auxiliary heads, quantized once
    per run; ``slot`` is the global index of this slot.  All three stages
    run for every node (three ``fake_quant`` launches) and each node's
    progress selects among them.

    ``cost_scale`` (N,) is the task lane's per-node scale: sensing, the
    result's transmission, the auxiliary head and every stage cost scale
    with it, in float32, as the ladder's table does."""
    sense, tx, aux_c = costs.sense, costs.tx_result, costs.aux_head
    stage_cost = costs.stage_costs(quant_bits)
    n = window.shape[0]
    if cost_scale is not None:
        sense, tx, aux_c = (sense * cost_scale, tx * cost_scale,
                            aux_c * cost_scale)
        stage_cost = _stage_costs(costs, quant_bits, cost_scale.device
                                  )[:, None] * cost_scale       # (3, N)

    engaged = it.active | (ladder_decision == DEFER)
    budget = state.stored_uj + harvested_uj
    can_run = engaged & (budget >= sense)
    zero = torch.zeros_like(budget)
    spend = torch.where(can_run, sense, zero)
    rem = budget - spend

    # resume-before-start: an in-flight inference owns the slot; otherwise
    # this slot's window is the stage-0 input
    fresh = can_run & ~it.active
    win_flat = F.pad(window.reshape(n, -1),
                     (0, it.acts.shape[1] - window[0].numel()))
    buf = torch.where(fresh[:, None], win_flat, it.acts)
    prog = torch.where(fresh, 0, it.stage)
    src = torch.where(fresh, slot, it.src_slot).to(torch.int32)

    # masked stage walk: a stage runs only where it is the next one and
    # strictly affordable from what remains
    for si in range(3):
        out_i = har_apply_stage(qp, buf, si, har_cfg, quant_bits)
        run_i = can_run & (prog == si) & (rem >= stage_cost[si] + reserve_uj)
        buf = torch.where(run_i[:, None], out_i, buf)
        prog = torch.where(run_i, prog + 1, prog)
        rem = torch.where(run_i, rem - stage_cost[si], rem)
        spend = torch.where(run_i, spend + stage_cost[si], spend)

    logits_full = buf[:, :har_cfg.n_classes]
    done = can_run & (prog == 3)
    emit_full = done & (rem >= tx + reserve_uj)

    aux_logits = har_apply_aux(qa, buf, prog, har_cfg)
    conf = torch.softmax(aux_logits, dim=-1).amax(dim=-1)
    emit_early = (can_run & ~done & (prog >= cfg.min_exit_stage)
                  & (rem >= aux_c + tx + reserve_uj)
                  & (conf >= cfg.exit_threshold))

    spend = (spend + torch.where(emit_full, tx, zero)
             + torch.where(emit_early, aux_c + tx, zero))
    emitted = emit_full | emit_early
    label = torch.where(emit_full, torch.argmax(logits_full, dim=-1),
                        torch.argmax(aux_logits, dim=-1)).to(torch.int32)

    def code(c):
        return torch.full_like(prog, c)

    decision = torch.where(
        emit_full, code(D8_STAGED_FULL),
        torch.where(emit_early, code(D7_EARLY_EXIT),
                    torch.where(can_run & (prog > 0), code(D6_PARTIAL),
                                code(DEFER))))
    # D7: a 2-B result and a 1-B confidence tag; D8: a 2-B result
    payload = torch.where(emit_full, torch.full_like(zero, 2.0),
                          torch.where(emit_early, torch.full_like(zero, 3.0),
                                      zero))
    stored = supercap_step_direct(state.stored_uj, harvested_uj, spend)
    new_it = IntermittentState(
        active=torch.where(can_run, ~emitted & (prog > 0), it.active),
        stage=torch.where(can_run, prog, it.stage),
        acts=buf, src_slot=src)
    return IntermittentLaneOut(
        engaged=engaged, decision=decision, spend=spend,
        payload_bytes=payload, stored_uj=stored,
        prev_label=torch.where(emitted, label, state.prev_label),
        emit=torch.where(emit_full, code(2),
                         torch.where(emit_early, code(1), code(0))),
        emit_label=label, emit_conf=conf, emit_src=src, emit_stage=prog,
        state=new_it)


def seeker_simulate(windows, labels, harvest, *, signatures, qdnn_params,
                    host_params, gen_params, har_cfg: HARConfig,
                    aac_table: AACTable | None = None,
                    costs: EnergyCosts | None = None, n_sensors: int = 3,
                    generator: torch.Generator | None = None,
                    noise: dict | None = None, quant_bits: int = 16,
                    brownout=None, intermittent=None,
                    aux_params: dict | None = None, device=None):
    """Run the Seeker system over one (S, T, C) window stream replicated to
    ``n_sensors`` nodes, ensembling their host logits (the paper's sensor
    ensemble): a thin wrapper over
    :func:`repro_torch.serving.fleet.seeker_fleet_simulate`.

    ``harvest`` is (S,) µJ per slot, shared by the sensors.  ``brownout``
    and ``intermittent`` (with ``aux_params``) are the fleet engine's lanes;
    with ``intermittent`` a D6 suspension does not count as completed."""
    from .fleet import seeker_fleet_simulate, to_device

    extra = ({} if intermittent is None else
             dict(intermittent=intermittent, aux_params=aux_params))
    fleet = seeker_fleet_simulate(
        windows, to_device(harvest, device)[None].expand(n_sensors, -1),
        signatures=signatures, qdnn_params=qdnn_params,
        host_params=host_params, gen_params=gen_params, har_cfg=har_cfg,
        aac_table=aac_table, costs=costs, generator=generator, noise=noise,
        quant_bits=quant_bits, brownout=brownout, device=device, **extra)
    s, t = fleet["decisions"].shape[0], to_device(windows, device).shape[-2]
    labels = to_device(labels, device)
    ens_logits = fleet["logits"].mean(dim=1)                 # (S, L)
    preds = torch.argmax(ens_logits, dim=-1)
    completed = fleet["decisions"][:, 0] != DEFER
    if intermittent is not None:
        completed = completed & (fleet["decisions"][:, 0] != D6_PARTIAL)
    hit = (preds == labels) & completed
    out = {
        "preds": preds,
        "labels": labels,
        "accuracy_completed": hit.sum() / torch.clamp(completed.sum(), min=1),
        "accuracy_scheduled": hit.to(torch.float32).mean(),
        "completed_frac": completed.to(torch.float32).mean(),
        "decisions": fleet["decisions"][:, 0],
        "payload_bytes": fleet["payload_bytes"][:, 0],
        "raw_bytes": float(raw_payload_bytes(t)) * torch.ones(
            (s,), device=preds.device),
        "stored_uj": fleet["stored_uj"][:, 0],
        "k_trace": fleet["k_trace"][:, 0],
        "alive": fleet["alive"][:, 0],
        "brownout": fleet["brownout"][:, 0],
        "brownout_slots": fleet["brownout_slots"],
        "brownout_events": fleet["brownout_events"],
    }
    if intermittent is not None:
        out.update({
            "it_emit": fleet["it_emit"][:, 0],
            "it_stage": fleet["it_stage"][:, 0],
            "it_full": fleet["it_full"],
            "it_early": fleet["it_early"],
        })
    return out


def seeker_simulate_reference(windows, labels, harvest, *, signatures,
                              qdnn_params, host_params, gen_params,
                              har_cfg: HARConfig,
                              aac_table: AACTable | None = None,
                              costs: EnergyCosts | None = None,
                              n_sensors: int = 3,
                              generator: torch.Generator | None = None,
                              noise: dict | None = None,
                              quant_bits: int = 16, device=None):
    """The per-sensor simulation: a Python loop over sensors, and within
    each over the slots of the (S, T, C) stream, of
    :func:`seeker_sensor_step` and :func:`seeker_host_step` on one node.

    Kept as the semantics oracle of the fleet engine: given the same
    ``noise`` (S, n_sensors, ...) (:func:`repro_torch.serving.fleet.
    draw_fleet_noise`'s layout; sensor i takes column i), or a
    ``generator`` in the same state (the noise is then drawn in the
    fleet's order), it returns :func:`seeker_simulate`'s traces.
    ``harvest`` is (S,) µJ per slot, shared by the sensors.  The D2
    weights are quantized once per call."""
    from .fleet import (_check_generator, _check_noise, draw_fleet_noise,
                        fleet_node_init, resolve_device, to_device)

    dev = resolve_device(device)
    costs = costs or EnergyCosts()
    windows = to_device(windows, dev, torch.float32)
    harvest = to_device(harvest, dev, torch.float32)
    s, t, c = windows.shape
    if noise is None:
        noise = draw_fleet_noise(_check_generator(generator, dev), s,
                                 n_sensors, t, c)
    else:
        noise = _check_noise(noise, s, n_sensors, t, c,
                             lambda v: to_device(v, dev, torch.float32))
    signatures = to_device(signatures, dev, torch.float32).contiguous()
    qp = quantize_params(to_device(qdnn_params, dev), quant_bits)
    host_params = to_device(host_params, dev)
    gen_params = to_device(gen_params, dev)
    aac_table = None if aac_table is None else to_device(aac_table, dev)

    traces = []
    for i in range(n_sensors):
        state = fleet_node_init(1, device=dev)
        tr = {"decision": [], "payload": [], "stored": [], "k": [],
              "logits": []}
        for si in range(s):
            nz = {k: v[si, i:i + 1] for k, v in noise.items()}
            out = seeker_sensor_step(
                windows[si:si + 1], state, harvest[si:si + 1], nz["u"],
                signatures=signatures, qp=qp, aac_table=aac_table,
                costs=costs, quant_bits=quant_bits)
            logits = seeker_host_step(
                out, nz["dirs"], nz["radii_u"], nz["latent"],
                host_params=host_params, gen_params=gen_params, t=t)
            state = out.state
            for key, v in (("decision", out.decision),
                           ("payload", out.payload_bytes),
                           ("stored", out.state.stored_uj),
                           ("k", out.coreset_k), ("logits", logits)):
                tr[key].append(v[0])
        traces.append({k: torch.stack(v) for k, v in tr.items()})
    # sensor ensemble (paper: the host ensembles the sensors)
    ens_logits = sum(tr["logits"] for tr in traces) / n_sensors
    preds = torch.argmax(ens_logits, dim=-1)
    labels = to_device(labels, dev)
    completed = traces[0]["decision"] != DEFER
    hit = (preds == labels) & completed
    return {
        "preds": preds,
        "labels": labels,
        "accuracy_completed": hit.sum() / torch.clamp(completed.sum(), min=1),
        "accuracy_scheduled": hit.to(torch.float32).mean(),
        "completed_frac": completed.to(torch.float32).mean(),
        "decisions": traces[0]["decision"],
        "payload_bytes": traces[0]["payload"],
        "raw_bytes": float(raw_payload_bytes(t)) * torch.ones((s,),
                                                             device=dev),
        "stored_uj": traces[0]["stored"],
        "k_trace": traces[0]["k"],
    }


# ---------------------------------------------------------------------------
# Coreset wire format: what crosses from edge to host
# ---------------------------------------------------------------------------

class WirePayload(NamedTuple):
    """Quantized cluster-coreset payload as it crosses the wire: int16 center
    codes, int8 radius codes, int8 counts (the paper's 2 B center / 1 B
    radius / 4-bit count format, §3.2.2), plus the per-window float ranges
    needed to dequantize on the host side."""

    c_codes: torch.Tensor    # (B, C, k, 2) int16
    r_codes: torch.Tensor    # (B, C, k) int8
    n_codes: torch.Tensor    # (B, C, k) int8
    lo: torch.Tensor         # (B, 1, 1, 1) center range low
    hi: torch.Tensor         # (B, 1, 1, 1) center range high
    rhi: torch.Tensor        # (B, 1, 1) radius range high


def encode_wire_coresets(centers: torch.Tensor, radii: torch.Tensor,
                         counts: torch.Tensor) -> WirePayload:
    """Quantize per-channel cluster coresets for transmission: centers
    (B, C, k, 2), radii (B, C, k), counts (B, C, k), the batched output of
    :func:`repro_torch.core.coreset.channel_cluster_coresets`.  Counts are
    clipped to the 4-bit field, so the payload is valid by construction."""
    lo = centers.amin(dim=(1, 2, 3), keepdim=True)
    hi = centers.amax(dim=(1, 2, 3), keepdim=True)
    c_codes = torch.round((centers - lo) / torch.clamp(hi - lo, min=1e-9)
                          * 65535.0 - 32768.0).to(torch.int16)
    rhi = radii.amax(dim=(1, 2), keepdim=True)
    r_codes = torch.round(radii / torch.clamp(rhi, min=1e-9) * 255.0
                          - 128.0).to(torch.int8)
    n_codes = torch.clamp(counts, 0, 15).to(torch.int8)
    return WirePayload(c_codes, r_codes, n_codes, lo, hi, rhi)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _dtype_name(x: torch.Tensor) -> str:
    """The dtype's name as numpy and JAX print it (``int16``)."""
    return str(x.dtype).removeprefix("torch.")


def _check_coreset_fields(p: WirePayload) -> None:
    """Dtypes and cross-field shapes of a cluster payload: host-side checks
    that read no tensor value."""
    c_codes, r_codes, n_codes = p.c_codes, p.r_codes, p.n_codes
    _check(c_codes.dtype == torch.int16,
           f"wire payload c_codes must be int16, got {_dtype_name(c_codes)}")
    _check(r_codes.dtype == torch.int8,
           f"wire payload r_codes must be int8, got {_dtype_name(r_codes)}")
    _check(n_codes.dtype == torch.int8,
           f"wire payload n_codes must be int8, got {_dtype_name(n_codes)}")
    _check(c_codes.ndim >= 2 and c_codes.shape[-1] == 2,
           f"wire payload c_codes must be (..., k, 2) 2-D center codes, "
           f"got shape {tuple(c_codes.shape)}")
    _check(tuple(r_codes.shape) == tuple(c_codes.shape[:-1]),
           f"wire payload r_codes shape {tuple(r_codes.shape)} does not "
           f"match c_codes {tuple(c_codes.shape)}")
    _check(n_codes.shape == r_codes.shape,
           f"wire payload n_codes shape {tuple(n_codes.shape)} does not "
           f"match r_codes {tuple(r_codes.shape)}")
    for name, f in (("lo", p.lo), ("hi", p.hi), ("rhi", p.rhi)):
        _check(torch.as_tensor(f).is_floating_point(),
               f"wire payload {name} range must be floating, got "
               f"{_dtype_name(torch.as_tensor(f))}")


def _dequantize_coresets(p: WirePayload):
    centers = ((p.c_codes.to(torch.float32) + 32768.0) / 65535.0
               * (p.hi - p.lo) + p.lo)
    radii = (p.r_codes.to(torch.float32) + 128.0) / 255.0 * p.rhi
    return centers, radii, p.n_codes.to(torch.int32)


def decode_wire_coresets(p: WirePayload):
    """Host-side dequantization; returns (centers, radii, counts int32).

    Defensive, as the host ingests payloads from untrusted radio bytes:
    dtypes and cross-field shapes, and the 4-bit count range, are checked,
    and a malformed payload raises ``ValueError``.  On a CUDA tensor the
    range check is one reduction and one synchronisation; the host server
    skips it, since its entries come from payloads validated once, when
    they were encoded or parsed from bytes."""
    _check_coreset_fields(p)
    if p.n_codes.numel():
        lo, hi = torch.stack(torch.aminmax(p.n_codes)).tolist()
        _check(lo >= 0 and hi <= 15,
               f"wire payload counts outside the 4-bit field [0, 15]: "
               f"min {lo}, max {hi}")
    return _dequantize_coresets(p)


def wire_payload_nbytes(k: int, channels: int) -> int:
    """Bytes the quantized code tensors put on the wire per window
    (excluding the 3 float range scalars): per channel, k x (2-D int16
    center + int8 radius + int8 count)."""
    return channels * cluster_payload_bytes(k, bytes_center=4, bytes_radius=1,
                                            bits_count=8)


# --- byte-level framing: what the host's untrusted ingest parses ----------

_WIRE_MAGIC = 0x5EEC          # "SEEker Coreset"
_WIRE_VERSION = 1
_WIRE_HEADER = 20             # 5 x uint32: magic, version, B, C, k


def _host_array(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def wire_payload_to_bytes(p: WirePayload) -> bytes:
    """Serialize a quantized coreset payload to one radio frame: a 20-B
    header (magic, version, B, C, k) followed by the little-endian code
    tensors and float ranges."""
    b, c, k, _ = p.c_codes.shape
    head = np.asarray([_WIRE_MAGIC, _WIRE_VERSION, b, c, k], "<u4")
    return b"".join([
        head.tobytes(),
        _host_array(p.c_codes).astype("<i2").tobytes(),
        _host_array(p.r_codes).astype("i1").tobytes(),
        _host_array(p.n_codes).astype("i1").tobytes(),
        _host_array(p.lo).astype("<f4").tobytes(),
        _host_array(p.hi).astype("<f4").tobytes(),
        _host_array(p.rhi).astype("<f4").tobytes(),
    ])


def wire_payload_from_bytes(buf: bytes) -> WirePayload:
    """Parse and validate one radio frame into a :class:`WirePayload` of
    CPU tensors (move them with ``.to(device)``).

    The host's trust boundary: buffer length, header fields, count codes
    and range floats are all checked, and a malformed frame raises
    ``ValueError`` with the reason: truncation, bad magic, counts outside
    the 4-bit field, or non-finite dequantization ranges."""
    buf = bytes(buf)
    _check(len(buf) >= _WIRE_HEADER,
           f"truncated wire frame: {len(buf)} B is shorter than the "
           f"{_WIRE_HEADER}-B header")
    magic, version, b, c, k = np.frombuffer(buf[:_WIRE_HEADER], "<u4")
    _check(magic == _WIRE_MAGIC,
           f"not a Seeker coreset frame (magic 0x{int(magic):X}, "
           f"want 0x{_WIRE_MAGIC:X})")
    _check(version == _WIRE_VERSION,
           f"unsupported wire version {int(version)} (want {_WIRE_VERSION})")
    b, c, k = int(b), int(c), int(k)
    _check(b > 0 and c > 0 and k > 0,
           f"degenerate wire dims B={b}, C={c}, k={k}")
    want = _WIRE_HEADER + 6 * b * c * k + 12 * b
    _check(len(buf) == want,
           f"truncated/oversized wire frame: {len(buf)} B, B={b} C={c} "
           f"k={k} needs {want} B")

    off = _WIRE_HEADER

    def take(count, dtype, shape):
        nonlocal off
        n = count * np.dtype(dtype).itemsize
        arr = np.frombuffer(buf[off:off + n], dtype).reshape(shape)
        off += n
        return arr

    c_codes = take(b * c * k * 2, "<i2", (b, c, k, 2))
    r_codes = take(b * c * k, "i1", (b, c, k))
    n_codes = take(b * c * k, "i1", (b, c, k))
    lo = take(b, "<f4", (b, 1, 1, 1))
    hi = take(b, "<f4", (b, 1, 1, 1))
    rhi = take(b, "<f4", (b, 1, 1))
    _check(bool((n_codes >= 0).all() and (n_codes <= 15).all()),
           f"wire frame counts outside the 4-bit field [0, 15]: "
           f"min {n_codes.min()}, max {n_codes.max()}")
    _check(bool(np.isfinite(lo).all() and np.isfinite(hi).all()
                and np.isfinite(rhi).all()),
           "wire frame dequantization ranges are not finite")
    _check(bool((hi >= lo).all()),
           "wire frame center range has hi < lo")
    return WirePayload(*(torch.from_numpy(a.copy()) for a in
                         (c_codes, r_codes, n_codes, lo, hi, rhi)))


# ---------------------------------------------------------------------------
# Sampling-coreset wire format (the D4 payload: samples + GAN conditioning)
# ---------------------------------------------------------------------------

class WireSamplePayload(NamedTuple):
    """Quantized importance-sampling payload on the wire: int8 time indices
    (1 B, paper §3.2.2), int16 value codes (2 B per channel) with the
    per-window dequantization range, and the first and second moments that
    condition the recovery generator (paper A.1)."""

    idx: torch.Tensor        # (B, m) int8 — selected time indices
    v_codes: torch.Tensor    # (B, m, C) int16 — quantized sample values
    lo: torch.Tensor         # (B, 1, 1) value range low
    hi: torch.Tensor         # (B, 1, 1) value range high
    mean: torch.Tensor       # (B, C) window mean (generator conditioning)
    var: torch.Tensor        # (B, C) window variance


def encode_wire_samples(indices: torch.Tensor, values: torch.Tensor,
                        mean: torch.Tensor, var: torch.Tensor
                        ) -> WireSamplePayload:
    """Quantize batched sampling coresets for transmission: indices (B, m),
    values (B, m, C), mean/var (B, C), the fields of
    :class:`repro_torch.core.coreset.SamplingCoreset`.  Indices must fit the
    int8 wire field (window length < 128); on a CUDA tensor that check is
    one reduction and one synchronisation."""
    if indices.numel():
        lo_i, hi_i = torch.stack(torch.aminmax(indices)).tolist()
        _check(lo_i >= 0 and hi_i <= 127,
               f"sample indices outside the int8 wire field [0, 127]: "
               f"min {lo_i}, max {hi_i}")
    lo = values.amin(dim=(1, 2), keepdim=True)
    hi = values.amax(dim=(1, 2), keepdim=True)
    v_codes = torch.round((values - lo) / torch.clamp(hi - lo, min=1e-9)
                          * 65535.0 - 32768.0).to(torch.int16)
    return WireSamplePayload(indices.to(torch.int8), v_codes, lo, hi,
                             mean.to(torch.float32), var.to(torch.float32))


def _check_sample_fields(p: WireSamplePayload) -> None:
    idx, v_codes = p.idx, p.v_codes
    _check(idx.dtype == torch.int8,
           f"sample payload idx must be int8, got {_dtype_name(idx)}")
    _check(v_codes.dtype == torch.int16,
           f"sample payload v_codes must be int16, got "
           f"{_dtype_name(v_codes)}")
    _check(v_codes.ndim >= 1
           and tuple(idx.shape) == tuple(v_codes.shape[:-1]),
           f"sample payload idx shape {tuple(idx.shape)} does not match "
           f"v_codes {tuple(v_codes.shape)}")
    mean, var = p.mean, p.var
    _check(mean.shape[-1] == v_codes.shape[-1]
           and var.shape[-1] == v_codes.shape[-1],
           f"sample payload moments {tuple(mean.shape)}/{tuple(var.shape)} "
           f"do not match channel dim of v_codes {tuple(v_codes.shape)}")


def _dequantize_samples(p: WireSamplePayload):
    values = ((p.v_codes.to(torch.float32) + 32768.0) / 65535.0
              * (p.hi - p.lo) + p.lo)
    return p.idx.to(torch.int32), values, p.mean, p.var


def decode_wire_samples(p: WireSamplePayload):
    """Host-side dequantization; returns (indices int32, values, mean, var).
    Defensive like :func:`decode_wire_coresets`: dtypes and shapes, and
    non-negative indices, are checked."""
    _check_sample_fields(p)
    if p.idx.numel():
        lo = int(p.idx.min())
        _check(lo >= 0,
               f"sample payload has negative time indices (min {lo})")
    return _dequantize_samples(p)


def wire_sample_nbytes(m: int, channels: int) -> int:
    """Bytes a sampling payload puts on the wire per window: m x (1-B index
    + 2-B value per channel) + the 2-B mean/var moments per channel."""
    return sampling_payload_bytes(m, channels=channels)


def _edge_encode_coresets(win: torch.Tensor, k: int) -> WirePayload:
    """Edge half of a serving tier: per-channel cluster coresets of a
    (B, T, C) window batch, one ``kmeans_coreset`` launch over the B * C
    channel clouds, quantized to the wire format."""
    cs = channel_cluster_coresets(win, k=k, iters=4)
    return encode_wire_coresets(cs.centers, cs.radii, cs.counts)


# ---------------------------------------------------------------------------
# The fleet's edge -> host tier, on one device or node-sharded
# ---------------------------------------------------------------------------

def fleet_serve_step(windows, *, host_params, har_cfg: HARConfig, mesh=None,
                     k: int = 12, noise: dict | None = None,
                     generator: torch.Generator | None = None,
                     seed: int = 0, noise_fn=None, host_state=None,
                     serve_cfg=None, gen_params=None, alive=None,
                     engine_alive=None, per_shard_host: bool = False,
                     device=None) -> dict:
    """The fleet's edge-to-host tier: every node's (N, T, C) window is
    clustered per channel (one ``kmeans_coreset`` launch over the N * C
    channel clouds) and quantized to the wire format; only those payloads
    reach the host.  The host work runs in one of three modes:

    * default: the batch is decoded, recovered and run through the DNN
      (:func:`repro_torch.host.server.recover_infer_batch`); the cluster
      recovery draws ``noise`` ``{"dirs": (N, C, T, 2), "radii_u":
      (N, C, T, 1)}``, or draws them from ``generator`` (default
      ``manual_seed(0)`` on the device);
    * ``host_state``/``serve_cfg``/``gen_params`` given: the payloads are
      enqueued into the host server (deadlines, EDF batches, recovery cache)
      and served; the recovery noise is keyed by each payload
      (``seed``/``noise_fn``, see :func:`repro_torch.host.server.host_serve_slot`).
      ``alive`` (the caller's churn mask) and ``engine_alive`` (one slot of
      the fleet engine's emitted ``res["alive"]``, brown-outs folded in)
      compose by AND: a dead node sends no frame;
    * ``per_shard_host=True`` (with a ``mesh`` and the queue mode's
      arguments): no payload crosses ranks.  Each rank serves its own node
      tile with its own server, row ``tile`` of the stacked ``host_state``
      (:func:`repro_torch.host.server.host_server_init_stacked` with one
      row per rank); only the QoS counters and the telemetry lanes are
      summed over the ranks.

    With a ``mesh`` (a ``DeviceMesh``; SPMD, every rank passes the same
    global arguments) each rank encodes only its node tile (the fleet
    padded with zero windows to the mesh quantum), and outside the
    per-shard mode the six payload fields are gathered in the global node
    order, padding cut, and the host runs on every rank as above.

    Returns ``wire_bytes`` (the quantized bytes the alive fleet sent;
    counting them reads the mask once, one synchronisation on a CUDA
    tensor), ``raw_bytes`` (the raw windows' equivalent), and
    ``host_logits`` (N, L) or ``host_state``/``slot_output``.  The
    per-shard mode returns the stacked ``host_state`` with this rank's row
    advanced (the other rows as given: each rank owns its row), this rank's
    ``slot_output``, the summed ``qos`` counters (``served``,
    ``deadline_misses``, ``drops_overflow``) and, with
    ``serve_cfg.telemetry``, the summed ``telemetry`` lanes."""
    from ..host.server import recover_infer_batch, serve_fleet_payloads
    from .fleet import _as_array, _gather_nodes, _tile, resolve_device, \
        to_device

    n, t, c = tuple(_as_array(windows).shape)
    with obs_trace.span("host.serve_step", {"nodes": n, "k": k}):
        if per_shard_host and mesh is None:
            raise ValueError("per_shard_host=True runs one host server per "
                             "node shard: pass the mesh")
        dev = resolve_device(device)
        shard = None if mesh is None else node_shard(mesh)
        if engine_alive is not None:
            engine_alive = to_device(engine_alive, dev, torch.bool)
            if tuple(engine_alive.shape) != (n,):
                raise ValueError(f"engine_alive must be (N,)=({n},), got "
                                 f"{tuple(engine_alive.shape)}")
            alive = engine_alive if alive is None else \
                to_device(alive, dev, torch.bool) & engine_alive
        if alive is not None:
            alive = to_device(alive, dev, torch.bool)
            if tuple(alive.shape) != (n,):
                raise ValueError(f"alive must be (N,)=({n},), got "
                                 f"{tuple(alive.shape)}")
            if host_state is None:
                raise ValueError("alive/engine_alive is a queue-mode "
                                 "argument: without a host_state there is no "
                                 "queue to keep dead nodes out of")
        if per_shard_host:
            return _fleet_serve_per_shard(
                windows, n=n, t=t, c=c, k=k, shard=shard,
                host_params=host_params, host_state=host_state,
                serve_cfg=serve_cfg, gen_params=gen_params, alive=alive,
                seed=seed, noise_fn=noise_fn, dev=dev)

        with obs_trace.span("host.encode"):
            _, lo, hi = (0, 0, n) if shard is None else shard.bounds(n)
            payload = _edge_encode_coresets(
                _tile(windows, n, lo, hi, dev, torch.float32), k)
            if shard is not None:
                payload = WirePayload(*(_gather_nodes(f, shard, n)
                                        for f in payload))
            n_tx = n if alive is None else int(alive.sum())  # frames sent
            out = {
                "wire_bytes": n_tx * wire_payload_nbytes(k, c),
                "raw_bytes": n * raw_payload_bytes(t) * c,
            }
        if host_state is None:
            noise = to_device(noise if noise is not None else _draw_recovery(
                generator, n, c, t, dev), dev, torch.float32)
            out["host_logits"] = recover_infer_batch(payload, host_params,
                                                     noise, t)
            return out
        if serve_cfg is None or gen_params is None:
            raise ValueError("fleet_serve_step host_state mode needs "
                             "serve_cfg and gen_params")
        state, slot_out = serve_fleet_payloads(
            host_state, payload,
            torch.arange(n, dtype=torch.int32, device=dev), cfg=serve_cfg,
            host_params=host_params, gen_params=gen_params,
            seed=seed, noise_fn=noise_fn, mask=alive)
        out["host_state"] = state
        out["slot_output"] = slot_out
        return out


def _draw_recovery(generator, n: int, c: int, t: int, dev) -> dict:
    """The direct mode's cluster-recovery draws for ``n`` rows: directions
    (N, C, T, 2), then radii (N, C, T, 1), from ``generator`` (default
    ``manual_seed(0)`` on ``dev``)."""
    g = generator or torch.Generator(device=dev).manual_seed(0)
    return {"dirs": torch.randn((n, c, t, 2), generator=g, device=dev),
            "radii_u": torch.rand((n, c, t, 1), generator=g, device=dev)}


def _fleet_serve_per_shard(windows, *, n, t, c, k, shard, host_params,
                           host_state, serve_cfg, gen_params, alive, seed,
                           noise_fn, dev) -> dict:
    """:func:`fleet_serve_step`'s per-shard mode: the rank's node tile is
    encoded and served by the rank's own server; the QoS counters (one
    all-reduce) and the telemetry lanes (:func:`repro_torch.obs.
    metrics_psum`) are all that crosses ranks."""
    import dataclasses

    from ..host.queue import tree_map
    from ..host.server import (cluster_entries, host_serve_slot,
                               host_telemetry_spec)
    from ..obs import metrics_psum
    from .fleet import _tile, to_device

    if serve_cfg is None or gen_params is None or host_state is None:
        raise ValueError("fleet_serve_step per_shard_host mode needs "
                         "host_state (stacked: host_server_init_stacked), "
                         "serve_cfg and gen_params")
    lead = host_state.queue.payload.kind.shape[0]      # the first leaf
    if lead != shard.quantum:
        raise ValueError(
            f"per_shard_host needs one host server per shard: host_state "
            f"is stacked for {lead} hosts, mesh quantum is {shard.quantum} "
            f"(use host_server_init_stacked(cfg, {shard.quantum}))")
    _, lo, hi = shard.bounds(n)
    n_local = hi - lo
    if n_local > serve_cfg.queue_capacity:
        raise ValueError(
            f"per-shard ingest lane of {n_local} nodes exceeds "
            f"queue_capacity={serve_cfg.queue_capacity}; raise "
            f"HostServeConfig.queue_capacity")
    # service rate: enough EDF microbatches to cover the local tile
    cfg = dataclasses.replace(
        serve_cfg, batches_per_slot=-(-n_local // serve_cfg.batch_size))
    # padding nodes (global index >= n) and dead nodes never enqueue
    mask = torch.arange(lo, hi, device=dev) < n
    if alive is not None:
        mask = mask & _tile(alive, n, lo, hi, dev)
    with obs_trace.span("host.encode"):
        payload = _edge_encode_coresets(
            _tile(windows, n, lo, hi, dev, torch.float32), k)
    with obs_trace.span("host.ingest"):
        entries = cluster_entries(payload, cfg.m)
    stacked = to_device(host_state, dev)
    row, slot_out = host_serve_slot(
        tree_map(lambda a: a[shard.index], stacked), entries,
        torch.arange(lo, hi, dtype=torch.int32, device=dev), mask, cfg=cfg,
        host_params=host_params, gen_params=gen_params, seed=seed,
        noise_fn=noise_fn)
    i = shard.index
    with obs_trace.span("host.finish"):
        new_state = tree_map(
            lambda a, r: torch.cat([a[:i], r[None].to(a.dtype), a[i + 1:]]),
            stacked, row)
    qos = all_reduce_sum(torch.stack([
        row.served, row.deadline_misses,
        row.queue.drops_overflow]).to(torch.int64), shard).tolist()
    n_tx = n if alive is None else int(alive.sum())
    out = {
        "wire_bytes": n_tx * wire_payload_nbytes(k, c),
        "raw_bytes": n * raw_payload_bytes(t) * c,
        "host_state": new_state,
        "slot_output": slot_out,
        "qos": dict(zip(("served", "deadline_misses", "drops_overflow"),
                        qos)),
    }
    if cfg.telemetry:
        with obs_trace.span("host.telemetry"):
            out["telemetry"] = metrics_psum(host_telemetry_spec(cfg),
                                            row.metrics, shard.group)
    return out


def edge_host_serve_step(windows, *, signatures, qdnn_params, host_params,
                         gen_params, har_cfg: HARConfig, mesh, k: int = 12,
                         quant_bits: int = 16, noise: dict | None = None,
                         generator: torch.Generator | None = None,
                         device=None) -> torch.Tensor:
    """Paired-tier serving across the ``"pod"`` dim of a ``DeviceMesh``.

    Each pod is the edge for its own sensor batch and the host for its peer
    pod: a rank clusters its tile of ``windows`` (B, T, C) (split over
    ("pod", "data") like the fleet's nodes) into the quantized coreset
    payload, sends the payload to the rank at ``(pod + 1) % npods`` on its
    ``data`` index (coreset bytes on the wire instead of raw windows; the
    identity with one pod), and recovers and classifies the batch it
    receives from ``(pod - 1) % npods``
    (:func:`repro_torch.host.server.recover_infer_batch`).  The recovery
    draws ``noise`` ``{"dirs": (B, C, T, 2), "radii_u": (B, C, T, 1)}``,
    indexed by the windows' global rows, or draws the whole batch's from
    ``generator`` (default ``manual_seed(0)``) as
    :func:`fleet_serve_step`'s direct mode does, each rank keeping its
    peer's rows.  ``signatures``, ``qdnn_params``, ``gen_params`` and
    ``quant_bits`` are the reference's arguments; the edge half here is
    the coreset encode.

    Returns the (B, L) host logits gathered in the global tile order: the
    block of rank ``r`` holds the logits of the windows of the rank one pod
    before it, as the reference's result is laid out."""
    from ..host.server import recover_infer_batch
    from ..sharding import tile_index
    from .fleet import _as_array, resolve_device, to_device

    dev = resolve_device(device)
    shard = node_shard(mesh)
    if "pod" not in shard.sizes:
        raise ValueError(f"edge_host_serve_step pairs pods: the mesh "
                         f"{tuple(shard.sizes)} has no 'pod' dim")
    windows = _as_array(windows)
    b, t, c = tuple(windows.shape)
    if b % shard.quantum:
        raise ValueError(f"the window batch of {b} does not split over the "
                         f"{shard.quantum} ranks of the mesh")
    size = b // shard.quantum
    lo = shard.index * size
    payload = _edge_encode_coresets(
        to_device(windows[lo:lo + size], dev, torch.float32), k)
    names = tuple(shard.sizes)
    pods = shard.sizes["pod"]

    def rank_at(shift):
        at = dict(shard.coords, pod=(shard.coords["pod"] + shift) % pods)
        return at, int(shard.grid[tuple(at[a] for a in names)])

    _, dst = rank_at(1)
    src_at, src = rank_at(-1)
    payload = WirePayload(*(exchange(f, shard, dst, src) for f in payload))
    src_lo = tile_index(src_at, shard.sizes, shard.axes) * size
    if noise is None:
        noise = _draw_recovery(generator, b, c, t, dev)
    noise = {key: to_device(_as_array(noise[key])[src_lo:src_lo + size],
                            dev, torch.float32)
             for key in ("dirs", "radii_u")}
    logits = recover_infer_batch(payload, host_params, noise, t)
    return all_gather_tiles(logits, shard, 0)
