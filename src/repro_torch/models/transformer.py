"""Run-structured decoder LM: the decoders whose input is tokens alone.

PyTorch counterpart of :mod:`repro.models.transformer` for decoders whose
layers are ``"attn"`` (global) and ``"local"`` (sliding-window) attention,
``"rglru"`` (Griffin's recurrent block) and ``"ssd"`` (Mamba-2), with a
dense or MoE FFN: tinyllama-1.1b, gemma-2b, yi-34b, gemma3-12b,
recurrentgemma-2b, deepseek-moe-16b, grok-1-314b and mamba2-130m.  Layers
are grouped into *runs* of consecutive identical (mixer, MoE) kinds
(``pattern_runs``); each run's parameters are stacked with a leading layer
dimension, in the reference's tree (``embed``, ``unembed``,
``final_norm``, ``runs[i]`` with ``norm1``, the mixer's leaves, ``norm2``
and ``mlp_*`` or the MoE leaves), and a run is a Python loop over that
dimension.

* :func:`forward`     — full sequence; ``return_cache=True`` also builds the
  serving cache (prefill).
* :func:`decode_step` — one token against the cache.
* :func:`init_params` / :func:`model_param_shapes` / :func:`init_cache`.

Configs with a part the port does not have yet (the Whisper encoder,
M-RoPE with vision patches, sinusoidal positions) raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, pattern_runs
from .flash import flash_banded_attention, flash_causal_attention
from .layers import (apply_rope, banded_attention, decode_attention,
                     dense_attention, geglu, pair_chunked_attention, rms_norm,
                     rope_sincos, swiglu)
from .moe import moe_apply, moe_param_shapes
from .rglru import (rglru_apply, rglru_decode_step, rglru_param_shapes,
                    rglru_state_shapes)
from .ssd import ssd_apply, ssd_decode_step, ssd_param_shapes, ssd_state_shapes

__all__ = ["PSpec", "model_param_shapes", "init_params", "compute_params",
           "forward", "decode_step", "init_cache", "check_supported"]

_PENDING = "ROADMAP Queue 1 item 7"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first part of ``cfg`` the
    port does not have yet."""
    if cfg.encoder_layers:
        missing = "the whisper encoder and cross-attention (encoder_layers)"
    elif cfg.mrope_sections or cfg.vision_patches:
        missing = "M-RoPE with vision patches (mrope_sections, vision_patches)"
    elif cfg.rope_theta == 0:
        missing = "sinusoidal positions (rope_theta=0)"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {missing} is not ported to repro_torch yet "
        f"({_PENDING}); only decoders whose input is tokens alone run")


class PSpec(NamedTuple):
    """Declarative parameter leaf: shape + init rule (stacked leaves have
    ``stacked`` set: their first dimension is the run's layer index)."""
    shape: tuple[int, ...]
    init: str = "normal"
    stacked: bool = False


def _act(cfg: ModelConfig):
    return {"swiglu": swiglu, "geglu": geglu}.get(cfg.mlp, geglu)


# ---------------------------------------------------------------------------
# Parameter shape declarations
# ---------------------------------------------------------------------------

def _mlp_shapes(cfg: ModelConfig, is_moe: bool) -> dict[str, PSpec]:
    d = cfg.d_model
    if is_moe and cfg.moe is not None:
        return {k: PSpec(v) for k, v in moe_param_shapes(d, cfg.moe).items()}
    sh = {}
    if cfg.mlp in ("swiglu", "geglu"):
        sh["mlp_gate"] = PSpec((d, cfg.d_ff))
    sh["mlp_up"] = PSpec((d, cfg.d_ff))
    sh["mlp_down"] = PSpec((cfg.d_ff, d))
    return sh


# the init rules of the recurrent mixers' leaves that are not weights
_INIT = {"lam": "rglru_lam", "A_log": "ssm_A", "dt_bias": "ssm_dt",
         "D": "ones", "norm_scale": "zeros"}


def _block_shapes(cfg: ModelConfig, kind: str,
                  is_moe: bool) -> dict[str, PSpec]:
    d, dh = cfg.d_model, cfg.head_dim
    sh = {"norm1": PSpec((d,), "zeros")}
    if kind in ("attn", "local"):
        sh.update({
            "wq": PSpec((d, cfg.n_heads, dh)),
            "wk": PSpec((d, cfg.n_kv, dh)),
            "wv": PSpec((d, cfg.n_kv, dh)),
            "wo": PSpec((cfg.n_heads, dh, d)),
        })
    else:
        shapes = (rglru_param_shapes(cfg) if kind == "rglru"
                  else ssd_param_shapes(cfg))
        sh.update({k: PSpec(v, _INIT.get(k, "normal"))
                   for k, v in shapes.items()})
    if cfg.mlp != "none" and kind != "ssd":
        sh["norm2"] = PSpec((d,), "zeros")
        sh.update(_mlp_shapes(cfg, is_moe))
    return sh


def model_param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter tree of ``cfg`` as :class:`PSpec` leaves, in the
    reference's order (that of its ``init_params``)."""
    check_supported(cfg)
    d = cfg.d_model
    tree: dict[str, Any] = {
        "embed": PSpec((cfg.padded_vocab, d)),
        "final_norm": PSpec((d,), "zeros"),
        "runs": [],
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = PSpec((d, cfg.padded_vocab))
    for kind, is_moe, _start, length in pattern_runs(cfg):
        tree["runs"].append({k: PSpec((length,) + v.shape, v.init, True)
                             for k, v in _block_shapes(cfg, kind,
                                                       is_moe).items()})
    return tree


def _draw(generator: torch.Generator, init: str, shape: tuple,
          fan_in: int, dt: torch.dtype) -> torch.Tensor:
    """One leaf (or one layer of a stacked leaf) by its init rule, drawn in
    float32 and cast to ``dt`` (``ssm_A`` is drawn in ``dt``, as in the
    reference)."""
    dev = generator.device

    def uniform(lo, hi, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev).uniform_(
            lo, hi, generator=generator)

    if init == "ssm_A":
        return torch.log(uniform(1.0, 16.0, dt))
    if init == "ssm_dt":
        u = uniform(1e-3, 1e-1)
        return (u + torch.log(-torch.expm1(-u))).to(dt)  # softplus^-1
    if init == "rglru_lam":
        # exp(-8 softplus(lam)) = a = u^2, u uniform in (0.9, 0.999)
        a = uniform(0.9, 0.999) ** 2
        return torch.log(torch.expm1(-torch.log(a) / 8.0)).to(dt)
    return (torch.randn(shape, generator=generator, device=dev)
            / math.sqrt(max(fan_in, 1.0))).to(dt)


def _init_leaf(generator: torch.Generator, p: PSpec,
               cfg: ModelConfig) -> torch.Tensor:
    dev, dt = generator.device, cfg.param_dtype
    if p.init in ("zeros", "ones"):
        fill = torch.zeros if p.init == "zeros" else torch.ones
        return fill(p.shape, dtype=dt, device=dev)
    # fan-in: product of all-but-last dims, the stacked layer dim excluded
    shape = p.shape[1:] if p.stacked else p.shape
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else shape[-1]
    if not p.stacked:
        return _draw(generator, p.init, shape, fan_in, dt)
    # layer by layer: the float32 draw holds one layer at a time
    out = torch.empty(p.shape, dtype=dt, device=dev)
    for i in range(p.shape[0]):
        out[i] = _draw(generator, p.init, shape, fan_in, dt)
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device, by the reference's
    laws (not its draws): normal / sqrt(fan_in) weights (an MoE leaf's
    fan-in counts its experts axis), zero norm scales, and the recurrent
    mixers' ``lam``, ``A_log``, ``dt_bias`` and ``D`` rules."""
    tree = model_param_shapes(cfg)
    out = {k: _init_leaf(generator, v, cfg) for k, v in tree.items()
           if k != "runs"}
    out["runs"] = [{k: _init_leaf(generator, v, cfg) for k, v in run.items()}
                   for run in tree["runs"]]
    return out


_READ_F32 = ("lam", "A_log", "dt_bias")


def compute_params(params: dict, cfg: ModelConfig, device=None) -> dict:
    """``params`` on ``device`` (where they are, by default) as the model's
    matmuls read them: every weight cast to ``cfg.dtype`` once (the same
    values as the reference's cast at each use), the leaves the reference
    reads in float32 (the norm scales, RG-LRU's ``lam``, SSD's ``A_log``
    and ``dt_bias``) kept as they are."""
    def cast(name, x):
        keep = "norm" in name or name in _READ_F32
        return x.to(device=device, dtype=None if keep else cfg.dtype)

    out = {k: cast(k, v) for k, v in params.items() if k != "runs"}
    out["runs"] = [{k: cast(k, v) for k, v in run.items()}
                   for run in params["runs"]]
    return out


# ---------------------------------------------------------------------------
# Blocks (full sequence)
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, chunk: int) -> int:
    return chunk if (s % chunk == 0 and s >= chunk) else s


def _project_qkv(p: dict, h: torch.Tensor, wq: torch.Tensor):
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, wq.to(dt))
    k = torch.einsum("bsd,dgk->bsgk", h, p["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bsgk", h, p["wv"].to(dt))
    return q, k, v


def _attn_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
              rope: tuple[torch.Tensor, torch.Tensor] | None):
    """Full-sequence causal attention mixer.  Returns (out, (k, v)).

    When ``cfg.head_pad_multiple`` pads the q-heads (gemma-2b 8 -> 16,
    yi-34b 56 -> 64), wq/wo are zero-padded and KV is gather-expanded to
    one stream per (padded) q-head, as in the reference: the padded heads'
    zero wo rows keep the math exact."""
    b, s, _ = x.shape
    hp = cfg.padded_heads
    expand = hp != cfg.n_heads
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, F.pad(p["wq"], (0, 0, 0, hp - cfg.n_heads))
                           if expand else p["wq"])
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    if expand:
        # per-q-head KV streams: the padded tail maps to group g-1 (masked
        # by wo's zero rows)
        rep = max(cfg.n_heads // cfg.n_kv, 1)
        kv_map = torch.clamp(torch.arange(hp, device=x.device) // rep,
                             max=cfg.n_kv - 1)
        k_att, v_att = k[:, :, kv_map], v[:, :, kv_map]
        q5 = q.reshape(b, s, hp, 1, cfg.head_dim)
    else:
        k_att, v_att = k, v
        q5 = q.reshape(b, s, cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim)
    window = cfg.window if kind == "local" else None
    if s <= cfg.dense_attn_max_seq and (window is None
                                        or not cfg.flash_attention):
        out = dense_attention(q5, k_att, v_att, window=window,
                              softcap=cfg.attn_softcap)
    elif window is not None:
        if cfg.flash_attention:
            out = flash_banded_attention(q5, k_att, v_att, window,
                                         _pick_chunk(s, cfg.attn_chunk),
                                         cfg.attn_softcap)
        else:
            out = banded_attention(q5, k_att, v_att, window=window,
                                   chunk=cfg.attn_chunk,
                                   softcap=cfg.attn_softcap)
    elif cfg.flash_attention:
        out = flash_causal_attention(q5, k_att, v_att,
                                     _pick_chunk(s, cfg.attn_chunk),
                                     cfg.attn_softcap)
    else:
        out = pair_chunked_attention(q5, k_att, v_att, chunk=cfg.attn_chunk,
                                     softcap=cfg.attn_softcap)
    out = out.reshape(b, s, hp, cfg.head_dim)
    wo = (F.pad(p["wo"], (0, 0, 0, 0, 0, hp - cfg.n_heads)) if expand
          else p["wo"])
    return torch.einsum("bshk,hkd->bsd", out, wo.to(x.dtype)), (k, v)


def _mlp(p: dict, x: torch.Tensor, cfg: ModelConfig,
         is_moe: bool) -> torch.Tensor:
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if is_moe and cfg.moe is not None:
        return moe_apply(p, h, cfg.moe, _act(cfg))
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        inner = _act(cfg)(h @ p["mlp_gate"].to(dt), h @ p["mlp_up"].to(dt))
    else:
        inner = F.gelu(h @ p["mlp_up"].to(dt), approximate="tanh")
    return inner @ p["mlp_down"].to(dt)


def _block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                 is_moe: bool, rope, want_state: bool = False):
    """One layer; returns (x, aux): the attention's (k, v), or with
    ``want_state`` a recurrent mixer's decode state (else None)."""
    if kind in ("attn", "local"):
        mix, aux = _attn_mix(p, x, cfg, kind=kind, rope=rope)
    else:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if kind == "rglru":
            out = rglru_apply(p, h, return_state=want_state)
        else:
            out = ssd_apply(p, h, cfg, return_state=want_state)
        mix, aux = out if want_state else (out, None)
    x = x + mix
    if cfg.mlp != "none" and kind != "ssd":
        x = x + _mlp(p, x, cfg, is_moe)
    return x, aux


def _run_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "attn" and cfg.global_rope_theta > 0:
        return cfg.global_rope_theta
    return cfg.rope_theta


def _run_rope(cfg: ModelConfig, kind: str, positions: torch.Tensor):
    """An attention run's RoPE sin/cos at ``positions`` (B, S), shared by
    its layers (the reference computes the same values in each layer);
    None for a recurrent run or without RoPE."""
    theta = _run_theta(cfg, kind)
    if kind not in ("attn", "local") or theta <= 0:
        return None
    return rope_sincos(positions, cfg.head_dim, theta)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Unembed + optional softcap + padded-vocab mask.  x: (B, S, D)."""
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x, unembed.to(cfg.dtype))
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.padded_vocab != cfg.vocab:
        ids = torch.arange(cfg.padded_vocab, device=x.device)
        pad_mask = torch.where(ids < cfg.vocab, 0.0, -1e30).to(logits.dtype)
        logits = logits + pad_mask
    return logits


def _embed_tokens(params: dict, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        # the factor is rounded to the compute dtype first, as in the
        # reference
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cfg.dtype,
                           device=x.device)
    return x


def _layer(p_run: dict, i: int) -> dict:
    return {k: v[i] for k, v in p_run.items()}


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            return_cache: bool = False, cache_len: int | None = None):
    """Full-sequence forward.

    tokens: (B, S) integer ids.  Returns logits (B, S, padded_vocab) in
    ``cfg.dtype``, or (logits, cache) with ``return_cache`` (prefill): the
    cache holds ``cache_len`` (default S) positions per global run and
    ``min(window, cache_len)`` per local run, in the ring layout
    slot = position % width, each recurrent run's final states, and
    ``pos`` = S.  An MoE config raises ``ValueError`` unless B*S is a
    multiple of ``min(group_size, B*S)``, an SSD config unless S is a
    multiple of ``min(128, S)``, as the reference asserts.
    """
    check_supported(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_tokens(params, cfg, tokens)
    run_caches = []
    for run_idx, (kind, is_moe, _start, length) in enumerate(
            pattern_runs(cfg)):
        p_run = params["runs"][run_idx]
        rope = _run_rope(cfg, kind, positions)
        auxs = []
        for i in range(length):
            x, aux = _block_apply(_layer(p_run, i), x, cfg, kind=kind,
                                  is_moe=is_moe, rope=rope,
                                  want_state=return_cache)
            if return_cache:
                auxs.append(aux)
        if return_cache:
            run_caches.append(_prefill_run_cache(auxs, cfg, kind,
                                                 cache_len or s, s))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    if not return_cache:
        return logits
    pos = torch.full((), s, dtype=torch.int32, device=tokens.device)
    return logits, {"pos": pos, "runs": run_caches}


def _prefill_run_cache(auxs: list, cfg: ModelConfig, kind: str,
                       cache_len: int, s: int) -> dict:
    """The decode cache of one run from its layers' prefill byproducts:
    k/v (B, S, G, Dh) each for attention, the final states otherwise."""
    if kind not in ("attn", "local"):
        return {name: torch.stack([a[name] for a in auxs])
                for name in auxs[0]}
    k = torch.stack([a[0] for a in auxs])
    v = torch.stack([a[1] for a in auxs])
    w = min(cfg.window, cache_len) if kind == "local" else cache_len
    if s >= w:
        k, v = k[:, :, s - w:], v[:, :, s - w:]
        if kind == "local":
            # ring layout: slot = pos % w
            k, v = torch.roll(k, s % w, dims=2), torch.roll(v, s % w, dims=2)
    else:
        k = F.pad(k, (0, 0, 0, 0, 0, w - s))
        v = F.pad(v, (0, 0, 0, 0, 0, w - s))
    return {"k": k.contiguous(), "v": v.contiguous()}


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _run_cache_shapes(cfg: ModelConfig, kind: str, length: int, batch: int,
                      max_len: int) -> dict[str, tuple]:
    if kind in ("attn", "local"):
        w = min(cfg.window, max_len) if kind == "local" else max_len
        shape = (length, batch, w, cfg.n_kv, cfg.head_dim)
        return {"k": shape, "v": shape}
    base = (rglru_state_shapes(cfg, batch) if kind == "rglru"
            else ssd_state_shapes(cfg, batch))
    return {k: (length,) + v for k, v in base.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """An empty decode cache on ``device`` in ``cfg.dtype``: per attention
    run k/v (L, B, W, G, Dh) (W = ``max_len``, or ``min(window, max_len)``
    for a local run), per recurrent run its zero states, and an int32
    ``pos`` of 0."""
    check_supported(cfg)
    runs = [{k: torch.zeros(v, dtype=cfg.dtype, device=device)
             for k, v in _run_cache_shapes(cfg, kind, length, batch,
                                           max_len).items()}
            for kind, _moe, _start, length in pattern_runs(cfg)]
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "runs": runs}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _slot_positions(pos: torch.Tensor, w: int) -> torch.Tensor:
    """Global position held by each of the w ring slots after writing ``pos``
    at slot pos % w.  (-1 where the slot is still empty.)"""
    i = torch.arange(w, device=pos.device)
    p = pos - torch.remainder(pos - i, w)
    return torch.where(p >= 0, p, -1)


def _attn_decode(p: dict, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 x: torch.Tensor, cfg: ModelConfig, *,
                 rope: tuple[torch.Tensor, torch.Tensor] | None,
                 slot: torch.Tensor, slot_pos: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """One token's attention mixer; writes its k/v into the caches (B, W,
    G, Dh) in place at ``slot`` (pos % W).  Decode keeps the unpadded GQA
    grouping."""
    b = x.shape[0]
    g, rep = cfg.n_kv, cfg.n_heads // cfg.n_kv
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, p["wq"])
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    q5 = q.reshape(b, 1, g, rep, cfg.head_dim)
    out = decode_attention(q5, k_cache, v_cache, slot_pos, pos,
                           softcap=cfg.attn_softcap)
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor):
    """One decoding step.  tokens: (B, 1).  Returns (logits (B, 1, V),
    cache): the returned cache holds ``pos + 1`` and the same tensors, into
    which this step's keys and values, and the recurrent runs' new states,
    were written in place."""
    check_supported(cfg)
    pos = cache["pos"]
    x = _embed_tokens(params, cfg, tokens)
    for run_idx, (kind, is_moe, _start, length) in enumerate(
            pattern_runs(cfg)):
        p_run, c_run = params["runs"][run_idx], cache["runs"][run_idx]
        if kind in ("attn", "local"):
            rope = _run_rope(cfg, kind, pos.expand(tokens.shape[0], 1))
            w = c_run["k"].shape[2]
            slot = torch.remainder(pos, w).reshape(1).long()
            slot_pos = _slot_positions(pos, w)
        for i in range(length):
            p_l = _layer(p_run, i)
            if kind in ("attn", "local"):
                mix = _attn_decode(p_l, c_run["k"][i], c_run["v"][i], x, cfg,
                                   rope=rope, slot=slot, slot_pos=slot_pos,
                                   pos=pos)
            else:
                state = _layer(c_run, i)
                h = rms_norm(x, p_l["norm1"], cfg.norm_eps)
                if kind == "rglru":
                    mix, new = rglru_decode_step(p_l, state, h)
                else:
                    mix, new = ssd_decode_step(p_l, state, h, cfg)
                for name, t in new.items():
                    state[name].copy_(t)
            x = x + mix
            if cfg.mlp != "none" and kind != "ssd":
                x = x + _mlp(p_l, x, cfg, is_moe)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    return logits, dict(cache, pos=pos + 1)
