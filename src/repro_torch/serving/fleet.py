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

The lanes of the JAX engine (churn, brown-out, intermittent inference,
task fleets, telemetry) are not ported yet: passing one raises
``NotImplementedError``.  The masks below keep the JAX engine's structure
(an exogenous alive lane gating every trace and aggregate) so the lanes
slot in later.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.aac import AACTable
from ..core.coreset import raw_payload_bytes
from ..core.decision import DEFER
from ..core.energy import EnergyCosts, predictor_init
from ..kernels.ops import signature_corr_op
from ..models.har import HARConfig, quantize_params
from .edge_host import (SeekerNodeState, seeker_host_step,
                        seeker_sensor_step_given_corr)

__all__ = ["N_DECISIONS", "NOISE_KEYS", "resolve_device", "to_device",
           "fleet_node_init", "draw_slot_noise", "draw_fleet_noise",
           "seeker_fleet_simulate", "wire_bytes_exact"]

N_DECISIONS = DEFER + 1   # D0..D4 + DEFER: bins of the fleet histogram
NOISE_KEYS = ("u", "dirs", "radii_u", "latent")
LATENT = 16

# lane keyword -> the ROADMAP item that ports it
_LANES = {
    "alive": "Queue 1 item 6, the churn lane",
    "brownout": "Queue 1 item 6, the brown-out lane",
    "intermittent": "Queue 1 item 6, the intermittent lane",
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


def _slot_body(state, win, harv, nz, *, signatures, qp, host_params,
               gen_params, aac_table, costs, quant_bits, k_max, m_samples,
               corr_threshold):
    """The slot for one block of nodes: correlation, sensor step, host."""
    corr = signature_corr_op(win, signatures)                 # (B, L)
    out = seeker_sensor_step_given_corr(
        win, state, harv, corr, nz["u"], qp=qp, aac_table=aac_table,
        costs=costs, k_max=k_max, m_samples=m_samples,
        quant_bits=quant_bits, corr_threshold=corr_threshold)
    logits = seeker_host_step(out, nz["dirs"], nz["radii_u"], nz["latent"],
                              host_params=host_params, gen_params=gen_params,
                              t=win.shape[-2])
    return out.state, {"decision": out.decision,
                       "payload": out.payload_bytes, "k": out.coreset_k,
                       "logits": logits}


def _fleet_aggregates(traces: dict, labels, per_node: bool) -> dict:
    """Masked fleet aggregates from (S, N) traces; the activity mask is the
    emitted alive lane."""
    act = traces["alive"]
    dec = traces["decision"]
    sent = (dec != DEFER) & act
    payload = torch.where(act, traces["payload"], 0.0)
    aggs = {
        "bytes_on_wire": payload.sum(),
        # payloads are whole bytes; int64 keeps the fleet total exact
        "bytes_on_wire_exact": torch.where(
            act, torch.round(traces["payload"]).to(torch.int64), 0).sum(),
        "decision_histogram": torch.bincount(dec[act].long(),
                                             minlength=N_DECISIONS),
        "completed": sent.sum(),
        "alive_slots": act.sum(),
    }
    if labels is None:
        return aggs
    preds = torch.argmax(traces["logits"], dim=-1)
    ok = (preds == labels) if per_node else (preds == labels[:, None])
    aggs["correct"] = (ok & sent).sum()
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
                          labels=None, alive=None, brownout=None,
                          intermittent=None, task=None, telemetry=None,
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
        node_block: run each slot in node blocks of this size (bounds the
            slot's working memory; more kernel launches per slot).
        device: ``None`` is CUDA (raises without it); ``"cpu"`` runs the
            kernels' plain versions.

    ``alive``, ``brownout``, ``intermittent``, ``task`` and ``telemetry``
    are the JAX engine's lanes, not ported yet: anything but ``None``
    raises ``NotImplementedError``.

    Returns a dict of time-major traces — ``decisions``/``payload_bytes``/
    ``stored_uj``/``k_trace``/``alive`` (S, N), ``logits`` (S, N, L),
    ``preds`` (S, N) — the aggregates ``bytes_on_wire`` (float32),
    ``bytes_on_wire_exact`` (int64, see :func:`wire_bytes_exact`),
    ``decision_histogram`` (N_DECISIONS,), ``completed``, ``alive_slots``,
    ``completed_frac``, ``raw_bytes_per_window``, with labels ``correct``
    and ``fleet_accuracy``, and ``final_state``.
    """
    lanes = dict(alive=alive, brownout=brownout, intermittent=intermittent,
                 task=task, telemetry=telemetry)
    for name, value in lanes.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported to repro_torch yet (ROADMAP "
                f"{_LANES[name]}); pass None")
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
    if state0 is None:
        state = fleet_node_init(n, predictor_window, initial_uj, dev)
    else:
        state = to_device(state0, dev)
        if state.stored_uj.shape[0] != n:
            raise ValueError(f"state0 is stacked for "
                             f"{state.stored_uj.shape[0]} nodes, fleet has {n}")
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
        host_params=to_device(host_params, dev),
        gen_params=to_device(gen_params, dev),
        aac_table=None if aac_table is None else to_device(aac_table, dev),
        costs=costs, quant_bits=quant_bits, k_max=k_max,
        m_samples=m_samples, corr_threshold=corr_threshold)

    per_slot = []
    for si in range(s):
        win_t = (xs_w[si].expand(n, t, c).contiguous() if shared_stream
                 else xs_w[si])
        nz = ({k: v[si] for k, v in noise.items()} if noise is not None
              else draw_slot_noise(generator, n, t, c))
        # the exogenous alive lane: all True until the churn lane is ported
        alive_t = torch.ones((n,), dtype=torch.bool, device=dev)
        parts = []
        for lo in range(0, n, block):
            sl = slice(lo, lo + block)
            parts.append(_slot_body(
                _tree_map(lambda x: x[sl], state), win_t[sl], harvest[sl, si],
                {k: v[sl] for k, v in nz.items()}, **params))
        new_state = _tree_map(lambda *xs: torch.cat(xs), *[p[0] for p in parts])
        trace = {k: torch.cat([p[1][k] for p in parts]) for k in parts[0][1]}

        # a dead node freezes its whole carry and emits DEFER with zero
        # payload (identity while every node is alive)
        def keep(new, old):
            a = alive_t.reshape((n,) + (1,) * (new.ndim - 1))
            return torch.where(a, new, old)

        state = _tree_map(keep, new_state, state)
        per_slot.append({
            "decision": torch.where(alive_t, trace["decision"], DEFER),
            "payload": torch.where(alive_t, trace["payload"], 0.0),
            "stored": state.stored_uj,
            "k": torch.where(alive_t, trace["k"], 0),
            "logits": torch.where(alive_t[:, None], trace["logits"], 0.0),
            "alive": alive_t,
        })
    traces = {k: torch.stack([p[k] for p in per_slot]) for k in per_slot[0]}

    aggs = _fleet_aggregates(traces, labels, per_node_labels)
    out = {
        "decisions": traces["decision"],
        "payload_bytes": traces["payload"],
        "stored_uj": traces["stored"],
        "k_trace": traces["k"],
        "logits": traces["logits"],
        "preds": torch.argmax(traces["logits"], dim=-1),
        "alive": traces["alive"],
        **aggs,
        "completed_frac": aggs["completed"] / torch.clamp(
            aggs["alive_slots"], min=1),
        "raw_bytes_per_window": torch.tensor(
            float(raw_payload_bytes(t)) * c, dtype=torch.float32, device=dev),
        "final_state": state,
    }
    if labels is not None:
        out["fleet_accuracy"] = aggs["correct"] / torch.clamp(
            aggs["completed"], min=1)
    return out


def wire_bytes_exact(res: dict) -> int:
    """The exact total bytes the fleet put on the wire, as a Python int
    (``bytes_on_wire`` is float32 and only approximate past 2**24)."""
    return int(res["bytes_on_wire_exact"])
