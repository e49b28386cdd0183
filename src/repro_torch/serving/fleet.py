"""Fleet-scale batched Seeker simulator on one device.

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

Randomness: every slot draws its (N, ...) batch of D4 and recovery noise
from one ``torch.Generator`` on the device (:func:`draw_slot_noise`), or
takes it from ``noise=``, a dict of pre-drawn (S, N, ...) tensors — how the
parity tests hand the port the numbers JAX drew.

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

The task and telemetry lanes are not ported yet: passing one raises
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.aac import AACTable
from ..core.coreset import raw_payload_bytes
from ..core.decision import (D4_SAMPLING, D6_PARTIAL, DEFER,
                             N_INTERMITTENT_DECISIONS, IntermittentConfig)
from ..core.energy import (BrownoutConfig, EnergyCosts, predictor_init,
                           supercap_step)
from ..kernels.ops import signature_corr_op
from ..models.har import HARConfig, quantize_params
from .edge_host import (IntermittentState, SeekerNodeState,
                        intermittent_fleet_init, intermittent_lane_step,
                        seeker_host_step, seeker_sensor_step_given_corr)
from .fleet_lanes import FLEET_LANES, FleetCarry, fleet_trace_keys

__all__ = ["N_DECISIONS", "NOISE_KEYS", "resolve_device", "to_device",
           "fleet_node_init", "draw_slot_noise", "draw_fleet_noise",
           "seeker_fleet_simulate", "wire_bytes_exact"]

N_DECISIONS = DEFER + 1   # D0..D4 + DEFER: bins of the fleet histogram
NOISE_KEYS = ("u", "dirs", "radii_u", "latent")
LATENT = 16

# engine keyword of each lane not registered yet -> the ROADMAP item that
# ports it
_UNPORTED_LANES = {
    "task": "Queue 1 item 6, the task lane",
    "telemetry": "Queue 1 items 6 and 10, the telemetry lane",
}


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


def _tree_map(fn, *trees):
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


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


def _check_noise(noise: dict, s: int, n: int, t: int, c: int, dev):
    want = {"u": (s, n, t), "dirs": (s, n, c, t, 2),
            "radii_u": (s, n, c, t, 1), "latent": (s, n, LATENT)}
    out = {}
    for k, shape in want.items():
        if k not in noise:
            raise ValueError(f"noise lacks {k!r}; it needs {sorted(want)}")
        v = to_device(noise[k], dev, torch.float32)
        if tuple(v.shape) != shape:
            raise ValueError(f"noise[{k!r}] must be {shape}, got "
                             f"{tuple(v.shape)}")
        out[k] = v
    return out


def _resolve_labels(labels, s: int, n: int, shared_stream: bool, dev):
    """(labels, per_node): a shared (S,) track (only with a shared stream)
    or per-node (S, N) tracks, validated like the JAX engine."""
    if labels is None:
        return None, False
    labels = to_device(labels, dev, torch.int64)
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


def _resolve_alive(alive, n: int, s: int, dev) -> torch.Tensor:
    """(N, S) bool churn trace; ``None`` is the always-present fleet."""
    if alive is None:
        return torch.ones((n, s), dtype=torch.bool, device=dev)
    alive = to_device(alive, dev, torch.bool)
    if tuple(alive.shape) != (n, s):
        raise ValueError(f"alive must be (N, S)=({n}, {s}) bool, got "
                         f"{tuple(alive.shape)}")
    return alive


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


def _slot_body(state, it, win, harv, nz, slot, *, signatures, qp, qa,
               host_params, gen_params, aac_table, costs, quant_bits, k_max,
               m_samples, corr_threshold, har_cfg, strict, intermittent,
               reserve_uj):
    """The slot for one block of nodes: correlation, sensor step, the
    intermittent lane (when on), host."""
    corr = signature_corr_op(win, signatures)                 # (B, L)
    out = seeker_sensor_step_given_corr(
        win, state, harv, corr, nz["u"], qp=qp, aac_table=aac_table,
        costs=costs, k_max=k_max, m_samples=m_samples,
        quant_bits=quant_bits, corr_threshold=corr_threshold,
        strict_energy=strict)
    lane_trace, new_it = {}, None
    if intermittent is not None:
        # the lane overrides the slots it engages, after the ladder
        lane = intermittent_lane_step(
            win, state, harv, out.decision, it, slot, qp=qp, qa=qa,
            har_cfg=har_cfg, costs=costs, quant_bits=quant_bits,
            cfg=intermittent, reserve_uj=reserve_uj)
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
    logits = seeker_host_step(out, nz["dirs"], nz["radii_u"], nz["latent"],
                              host_params=host_params, gen_params=gen_params,
                              t=win.shape[-2])
    return out.state, new_it, {"decisions": out.decision,
                               "payload_bytes": out.payload_bytes,
                               "k_trace": out.coreset_k, "logits": logits,
                               **lane_trace}


def _fleet_aggregates(traces: dict, exo_alive: torch.Tensor, labels,
                      per_node: bool,
                      intermittent: IntermittentConfig | None,
                      slot0: int) -> dict:
    """Masked fleet aggregates from (S, N) traces.  The activity mask is
    the emitted alive lane (exogenous and not browned out); ``exo_alive``
    is the exogenous trace alone, which counts the slots the brown-out
    hysteresis took.

    With the intermittent lane a D6 suspension is no completion, the
    histogram has the 9 codes, and each lane emission is scored against
    the label of its source slot (``it_src``; emissions of a window from
    before ``slot0`` are not scored)."""
    act = traces["alive"]
    dec = traces["decisions"]
    sent = (dec != DEFER) & act
    n_bins = N_DECISIONS
    if intermittent is not None:
        sent = sent & (dec != D6_PARTIAL)
        n_bins = N_INTERMITTENT_DECISIONS
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
    if labels is None:
        return aggs
    preds = torch.argmax(traces["logits"], dim=-1)
    ok = (preds == labels) if per_node else (preds == labels[:, None])
    if intermittent is None:
        aggs["correct"] = (ok & sent).sum()
        return aggs
    rel = traces["it_src"] - slot0
    valid = (traces["it_emit"] > 0) & act & (rel >= 0)
    rel_c = rel.clamp(0, dec.shape[0] - 1).long()
    lab = torch.gather(labels, 0, rel_c) if per_node else labels[rel_c]
    it_ok = (traces["it_label"] == lab) & valid
    aggs["correct_ladder"] = (ok & sent & (dec <= D4_SAMPLING)).sum()
    aggs["it_correct_full"] = (it_ok & (traces["it_emit"] == 2)).sum()
    aggs["it_correct_early"] = (it_ok & (traces["it_emit"] == 1)).sum()
    aggs["correct"] = (aggs["correct_ladder"] + aggs["it_correct_full"]
                       + aggs["it_correct_early"])
    return aggs


def seeker_fleet_simulate(windows, harvest, *, signatures, qdnn_params,
                          host_params, gen_params, har_cfg: HARConfig,
                          aac_table: AACTable | None = None,
                          costs: EnergyCosts | None = None,
                          generator: torch.Generator | None = None,
                          noise: dict | None = None, quant_bits: int = 16,
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
                          task=None, telemetry=None,
                          node_block: int | None = None, device=None):
    """Simulate N independent Seeker nodes over S time slots.

    Args:
        windows: (S, T, C) — one stream shared by every node, or
            (N, S, T, C) — a stream per node.
        harvest: (N, S) µJ harvested per node per slot.
        generator: ``torch.Generator`` on ``device`` for the per-slot noise;
            default ``manual_seed(0)``.  Ignored when ``noise`` is given.
        noise: optional dict of pre-drawn (S, N, ...) tensors with the keys
            and per-slot shapes of :func:`draw_slot_noise`.
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
        node_block: run each slot in node blocks of this size (bounds the
            slot's working memory; more kernel launches per slot).
        device: ``None`` is CUDA (raises without it); ``"cpu"`` runs the
            kernels' plain versions.

    ``task`` and ``telemetry`` are the JAX engine's lanes not ported yet:
    anything but ``None`` raises ``NotImplementedError``.

    Returns a dict of time-major (S, N) traces — ``decisions``,
    ``payload_bytes``, ``stored_uj``, ``k_trace``, ``logits`` (S, N, L),
    ``preds``, ``alive`` (the emitted lane: exogenous and not browned out)
    and ``brownout`` (the flag each slot was entered with) — the
    aggregates ``bytes_on_wire`` (float32), ``bytes_on_wire_exact`` (int64,
    see :func:`wire_bytes_exact`), ``decision_histogram``, ``completed``,
    ``alive_slots``, ``completed_frac``, ``brownout_slots``,
    ``brownout_events`` and ``raw_bytes_per_window``, with labels
    ``correct`` and ``fleet_accuracy``, and ``final_state`` and
    ``final_brownout``.  With ``intermittent`` also the traces ``it_emit``
    (0 none, 1 early exit, 2 full depth), ``it_label``, ``it_conf``,
    ``it_src`` and ``it_stage``, the counters ``it_full`` and ``it_early``
    (with labels ``correct_ladder``, ``it_correct_full`` and
    ``it_correct_early``; ``correct`` is then their sum) and
    ``final_intermittent``.
    """
    for name, value in (("task", task), ("telemetry", telemetry)):
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported to repro_torch yet (ROADMAP "
                f"{_UNPORTED_LANES[name]}); pass None")
    dev = resolve_device(device)
    costs = costs or EnergyCosts()
    harvest = to_device(harvest, dev, torch.float32)
    windows = to_device(windows, dev, torch.float32)
    n, s = harvest.shape
    if windows.ndim not in (3, 4):
        raise ValueError(f"windows must be (S,T,C) or (N,S,T,C), got "
                         f"{tuple(windows.shape)}")
    shared_stream = windows.ndim == 3
    if shared_stream:
        if windows.shape[0] != s:
            raise ValueError(f"windows {tuple(windows.shape)} vs S={s}")
        xs_w = windows.contiguous()                           # (S, T, C)
    else:
        if tuple(windows.shape[:2]) != (n, s):
            raise ValueError(f"windows {tuple(windows.shape)} vs (N, S)="
                             f"({n}, {s})")
        xs_w = windows.transpose(0, 1).contiguous()           # (S, N, T, C)
    t, c = windows.shape[-2:]
    if (t, c) != (har_cfg.window, har_cfg.channels):
        raise ValueError(f"windows are (T, C)=({t}, {c}), the model takes "
                         f"({har_cfg.window}, {har_cfg.channels})")
    labels, per_node_labels = _resolve_labels(labels, s, n, shared_stream,
                                              dev)
    exo_alive = _resolve_alive(alive, n, s, dev)
    if state0 is None:
        state = fleet_node_init(n, predictor_window, initial_uj, dev)
    else:
        state = to_device(state0, dev)
        if state.stored_uj.shape[0] != n:
            raise ValueError(f"state0 is stacked for "
                             f"{state.stored_uj.shape[0]} nodes, fleet has {n}")
    _validate_intermittent_args(intermittent, intermittent_state0,
                                aux_params, n)
    it = None
    if intermittent is not None:
        it = (intermittent_fleet_init(n, har_cfg, dev)
              if intermittent_state0 is None
              else to_device(intermittent_state0, dev))
    carry = FleetCarry(
        node=state, intermittent=it, telemetry=None,
        brownout=_resolve_brownout0(brownout_state0, state, brownout, n))
    if noise is not None:
        noise = _check_noise(noise, s, n, t, c, dev)
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator.device != dev:
            raise ValueError(f"generator is on {generator.device}, the run "
                             f"on {dev}")
    block = n if node_block is None else max(1, min(node_block, n))
    params = dict(
        signatures=to_device(signatures, dev, torch.float32).contiguous(),
        qp=quantize_params(to_device(qdnn_params, dev), quant_bits),
        qa=(None if intermittent is None else
            quantize_params(to_device(aux_params, dev), quant_bits)),
        host_params=to_device(host_params, dev),
        gen_params=to_device(gen_params, dev),
        aac_table=None if aac_table is None else to_device(aac_table, dev),
        costs=costs, quant_bits=quant_bits, k_max=k_max,
        m_samples=m_samples, corr_threshold=corr_threshold, har_cfg=har_cfg,
        # strict store-and-execute energy when either lane is on
        strict=brownout is not None or intermittent is not None,
        intermittent=intermittent,
        reserve_uj=brownout.off_uj if brownout is not None else 0.0)
    keep_fields = [ln.carry_field for ln in FLEET_LANES if ln.freeze == "keep"]

    per_slot = []
    for si in range(s):
        win_t = (xs_w[si].expand(n, t, c).contiguous() if shared_stream
                 else xs_w[si])
        nz = ({k: v[si] for k, v in noise.items()} if noise is not None
              else draw_slot_noise(generator, n, t, c))
        harv_t = harvest[:, si]
        alive_t = exo_alive[:, si]
        browned = carry.brownout
        # a node runs when its trace says so and its supercap allows
        alive_eff = alive_t & ~browned if brownout is not None else alive_t
        parts = []
        for lo in range(0, n, block):
            sl = slice(lo, lo + block)
            parts.append(_slot_body(
                _tree_map(lambda x: x[sl], carry.node),
                _tree_map(lambda x: x[sl], carry.intermittent), win_t[sl],
                harv_t[sl], {k: v[sl] for k, v in nz.items()}, slot0 + si,
                **params))
        new = carry._replace(
            node=_tree_map(lambda *xs: torch.cat(xs), *[p[0] for p in parts]),
            intermittent=_tree_map(lambda *xs: torch.cat(xs),
                                   *[p[1] for p in parts]))
        trace = {k: torch.cat([p[2][k] for p in parts]) for k in parts[0][2]}

        # every 'keep' lane freezes through dead and browned-out slots
        def keep(new_x, old_x):
            a = alive_eff.reshape((n,) + (1,) * (new_x.ndim - 1))
            return torch.where(a, new_x, old_x)

        new = new._replace(**{f: _tree_map(keep, getattr(new, f),
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
        carry = new._replace(node=node, brownout=next_browned)
        out_t = {
            "decisions": torch.where(alive_eff, trace["decisions"], DEFER),
            "payload_bytes": torch.where(alive_eff, trace["payload_bytes"],
                                         0.0),
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
        per_slot.append(out_t)
    traces = {k: torch.stack([p[k] for p in per_slot]) for k in per_slot[0]}
    traces["preds"] = torch.argmax(traces["logits"], dim=-1)

    aggs = _fleet_aggregates(traces, exo_alive.T, labels, per_node_labels,
                             intermittent, slot0)
    lane_args = {"alive": alive, "brownout": brownout,
                 "intermittent": intermittent}
    active = frozenset(ln.name for ln in FLEET_LANES
                       if lane_args.get(ln.config_kwarg) is not None)
    out = {k: traces[k] for k in fleet_trace_keys(active)}
    out.update(aggs)
    out.update(
        completed_frac=aggs["completed"] / torch.clamp(aggs["alive_slots"],
                                                       min=1),
        raw_bytes_per_window=torch.tensor(
            float(raw_payload_bytes(t)) * c, dtype=torch.float32, device=dev),
        final_state=carry.node, final_brownout=carry.brownout)
    if intermittent is not None:
        out["final_intermittent"] = carry.intermittent
    if labels is not None:
        out["fleet_accuracy"] = aggs["correct"] / torch.clamp(
            aggs["completed"], min=1)
    return out


def wire_bytes_exact(res: dict) -> int:
    """The exact total bytes the fleet put on the wire, as a Python int
    (``bytes_on_wire`` is float32 and only approximate past 2**24)."""
    return int(res["bytes_on_wire_exact"])
