"""Seeker edge-host serving: the paper's decision flow (Fig. 8) for a
batch of nodes.

PyTorch counterpart of the bare slot of :mod:`repro.serving.edge_host`.
:func:`seeker_sensor_step_given_corr` and :func:`seeker_host_step` are
written batched over a leading node axis — the JAX fleet's ``vmap`` over
nodes written out — and take their random draws as tensors:

* the sensor step takes ``u`` (N, T), the D4 Gumbel uniforms;
* the host step takes ``dirs`` (N, C, T, 2), ``radii_u`` (N, C, T, 1) and
  ``latent`` (N, 16), the cluster- and sampling-recovery draws.

Every branch (D2's quantized DNN, D3's cluster coresets, D4's sampling
coreset and both host recoveries) runs for every node every slot; the
decision only selects among the results, as in the JAX engine.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.aac import AACTable, select_k
from ..core.coreset import (ClusterCoreset, SamplingCoreset,
                            channel_cluster_coresets, importance_coreset,
                            raw_payload_bytes, sampling_payload_bytes)
from ..core.decision import (D0_MEMO, D2_DNN_QUANT, D3_CLUSTER, D4_SAMPLING,
                             DEFER, choose_decision)
from ..core.energy import (EnergyCosts, PredictorState, predictor_forecast,
                           predictor_init, predictor_update, supercap_step,
                           supercap_step_direct)
from ..core.recovery import (GeneratorParams, recover_cluster_window,
                             recover_sampling_window)
from ..models.har import HARConfig, har_apply, har_apply_quantized_nodes

__all__ = ["SeekerNodeState", "SensorStepOut", "seeker_node_init",
           "seeker_sensor_step_given_corr", "seeker_host_step",
           "seeker_simulate"]


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


def seeker_sensor_step_given_corr(
        window: torch.Tensor, state: SeekerNodeState,
        harvested_uj: torch.Tensor, corr: torch.Tensor, u: torch.Tensor, *,
        qp: dict, aac_table: AACTable | None,
        costs: EnergyCosts, k_max: int = 12, m_samples: int = 20,
        quant_bits: int = 16, corr_threshold: float = 0.95,
        strict_energy: bool = False) -> SensorStepOut:
    """One sensing slot on N nodes with the signature correlations
    ``corr`` (N, L) precomputed.  ``qp`` is the pre-quantized D2 network
    (:func:`repro_torch.models.har.quantize_params`), so a fleet run
    quantizes its weights once; ``u`` (N, T) is the D4 Gumbel uniforms.
    ``strict_energy`` switches the ladder to store-and-execute accounting."""
    max_corr = corr.amax(dim=-1)
    memo_label = torch.argmax(corr, dim=-1).to(torch.int32)

    predictor = predictor_update(state.predictor, harvested_uj)
    forecast = predictor_forecast(predictor)
    outcome = choose_decision(
        max_corr, state.stored_uj, forecast, costs,
        corr_threshold=corr_threshold,
        harvested_uj=harvested_uj if strict_energy else None)
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
    bytes_by_decision = torch.tensor([
        2.0,                                              # D0: a label
        2.0, 2.0,                                         # D1/D2: a result
        0.0,                                              # D3: AAC (below)
        float(sampling_payload_bytes(m_samples, channels=c)),
        0.0,                                              # DEFER
    ], dtype=torch.float32, device=window.device)
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


def seeker_simulate(windows, labels, harvest, *, signatures, qdnn_params,
                    host_params, gen_params, har_cfg: HARConfig,
                    aac_table: AACTable | None = None,
                    costs: EnergyCosts | None = None, n_sensors: int = 3,
                    generator: torch.Generator | None = None,
                    noise: dict | None = None, quant_bits: int = 16,
                    brownout=None, intermittent=None, device=None):
    """Run the Seeker system over one (S, T, C) window stream replicated to
    ``n_sensors`` nodes, ensembling their host logits (the paper's sensor
    ensemble): a thin wrapper over
    :func:`repro_torch.serving.fleet.seeker_fleet_simulate`.

    ``harvest`` is (S,) µJ per slot, shared by the sensors.  The brown-out
    and intermittent lanes are not ported yet: a value other than ``None``
    raises ``NotImplementedError``."""
    from .fleet import seeker_fleet_simulate, to_device

    fleet = seeker_fleet_simulate(
        windows, to_device(harvest, device)[None].expand(n_sensors, -1),
        signatures=signatures, qdnn_params=qdnn_params,
        host_params=host_params, gen_params=gen_params, har_cfg=har_cfg,
        aac_table=aac_table, costs=costs, generator=generator, noise=noise,
        quant_bits=quant_bits, brownout=brownout, intermittent=intermittent,
        device=device)
    s, t = fleet["decisions"].shape[0], to_device(windows, device).shape[-2]
    labels = to_device(labels, device)
    ens_logits = fleet["logits"].mean(dim=1)                 # (S, L)
    preds = torch.argmax(ens_logits, dim=-1)
    completed = fleet["decisions"][:, 0] != DEFER
    hit = (preds == labels) & completed
    return {
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
    }
