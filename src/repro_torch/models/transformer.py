"""Run-structured decoder LM: the attention-only architectures.

PyTorch counterpart of :mod:`repro.models.transformer` for decoders whose
layers are ``"attn"`` (global) and ``"local"`` (sliding-window) attention
with a dense FFN: tinyllama-1.1b, gemma-2b, yi-34b and gemma3-12b.  Layers
are grouped into *runs* of consecutive identical kinds (``pattern_runs``);
each run's parameters are stacked with a leading layer dimension, in the
reference's tree (``embed``, ``unembed``, ``final_norm``, ``runs[i]`` with
``norm1``, ``wq``, ``wk``, ``wv``, ``wo``, ``norm2``, ``mlp_*``), and a run
is a Python loop over that dimension.

* :func:`forward`     — full sequence; ``return_cache=True`` also builds the
  serving cache (prefill).
* :func:`decode_step` — one token against the cache.
* :func:`init_params` / :func:`model_param_shapes` / :func:`init_cache`.

Configs with a mixer the port does not have yet (RG-LRU, SSD, MoE FFNs, the
Whisper encoder, M-RoPE with vision patches, sinusoidal positions) raise
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

__all__ = ["PSpec", "model_param_shapes", "init_params", "compute_params",
           "forward", "decode_step", "init_cache", "check_supported"]

_PENDING = "ROADMAP Queue 1 item 7"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first part of ``cfg`` whose
    mixer the port does not have yet."""
    other = sorted(set(cfg.block_pattern) - {"attn", "local"})
    if other:
        missing = f"the {other[0]!r} mixer"
    elif cfg.moe_layers:
        missing = "the MoE FFN (moe_layers)"
    elif cfg.encoder_layers:
        missing = "the whisper encoder and cross-attention (encoder_layers)"
    elif cfg.mrope_sections or cfg.vision_patches:
        missing = "M-RoPE with vision patches (mrope_sections, vision_patches)"
    elif cfg.rope_theta == 0:
        missing = "sinusoidal positions (rope_theta=0)"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {missing} is not ported to repro_torch yet "
        f"({_PENDING}); only attention decoders with a dense FFN run")


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

def _block_shapes(cfg: ModelConfig) -> dict[str, PSpec]:
    d, dh = cfg.d_model, cfg.head_dim
    sh = {
        "norm1": PSpec((d,), "zeros"),
        "wq": PSpec((d, cfg.n_heads, dh)),
        "wk": PSpec((d, cfg.n_kv, dh)),
        "wv": PSpec((d, cfg.n_kv, dh)),
        "wo": PSpec((cfg.n_heads, dh, d)),
    }
    if cfg.mlp != "none":
        sh["norm2"] = PSpec((d,), "zeros")
        if cfg.mlp in ("swiglu", "geglu"):
            sh["mlp_gate"] = PSpec((d, cfg.d_ff))
        sh["mlp_up"] = PSpec((d, cfg.d_ff))
        sh["mlp_down"] = PSpec((cfg.d_ff, d))
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
    for _kind, _moe, _start, length in pattern_runs(cfg):
        tree["runs"].append({k: PSpec((length,) + v.shape, v.init, True)
                             for k, v in _block_shapes(cfg).items()})
    return tree


def _init_leaf(generator: torch.Generator, p: PSpec,
               cfg: ModelConfig) -> torch.Tensor:
    dev, dt = generator.device, cfg.param_dtype
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=dev)
    # fan-in: product of all-but-last dims, the stacked layer dim excluded
    shape = p.shape[1:] if p.stacked else p.shape
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else shape[-1]
    return (torch.randn(p.shape, generator=generator, device=dev)
            / math.sqrt(max(fan_in, 1.0))).to(dt)


def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device: normal / sqrt(fan_in)
    weights (the reference's law; not its draws), zero norm scales."""
    tree = model_param_shapes(cfg)
    out = {k: _init_leaf(generator, v, cfg) for k, v in tree.items()
           if k != "runs"}
    out["runs"] = [{k: _init_leaf(generator, v, cfg) for k, v in run.items()}
                   for run in tree["runs"]]
    return out


def compute_params(params: dict, cfg: ModelConfig, device=None) -> dict:
    """``params`` on ``device`` (where they are, by default) as the model's
    matmuls read them: every weight cast to ``cfg.dtype`` once (the same
    values as the reference's cast at each use), the norm scales kept as
    they are (they are read in float32)."""
    def cast(name, x):
        dt = None if "norm" in name else cfg.dtype
        return x.to(device=device, dtype=dt)

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


def _mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        inner = _act(cfg)(h @ p["mlp_gate"].to(dt), h @ p["mlp_up"].to(dt))
    else:
        inner = F.gelu(h @ p["mlp_up"].to(dt), approximate="tanh")
    return inner @ p["mlp_down"].to(dt)


def _block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                 rope: tuple[torch.Tensor, torch.Tensor] | None):
    """One layer; returns (x, (k, v))."""
    mix, kv = _attn_mix(p, x, cfg, kind=kind, rope=rope)
    x = x + mix
    if cfg.mlp != "none":
        x = x + _mlp(p, x, cfg)
    return x, kv


def _run_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "attn" and cfg.global_rope_theta > 0:
        return cfg.global_rope_theta
    return cfg.rope_theta


def _run_rope(cfg: ModelConfig, kind: str, positions: torch.Tensor):
    """A run's RoPE sin/cos at ``positions`` (B, S), shared by its layers
    (the reference computes the same values in each layer)."""
    theta = _run_theta(cfg, kind)
    return rope_sincos(positions, cfg.head_dim, theta) if theta > 0 else None


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
    slot = position % width, and ``pos`` = S.
    """
    check_supported(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_tokens(params, cfg, tokens)
    run_caches = []
    for run_idx, (kind, _moe, _start, length) in enumerate(pattern_runs(cfg)):
        p_run = params["runs"][run_idx]
        rope = _run_rope(cfg, kind, positions)
        ks, vs = [], []
        for i in range(length):
            x, (k, v) = _block_apply(_layer(p_run, i), x, cfg, kind=kind,
                                     rope=rope)
            if return_cache:
                ks.append(k)
                vs.append(v)
        if return_cache:
            run_caches.append(_prefill_run_cache(
                torch.stack(ks), torch.stack(vs), cfg, kind, cache_len or s,
                s))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    if not return_cache:
        return logits
    pos = torch.full((), s, dtype=torch.int32, device=tokens.device)
    return logits, {"pos": pos, "runs": run_caches}


def _prefill_run_cache(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                       kind: str, cache_len: int, s: int) -> dict:
    """The decode cache of one run from its prefill k/v (L, B, S, G, Dh)."""
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

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """An empty decode cache on ``device``: per run k/v (L, B, W, G, Dh) in
    ``cfg.dtype`` (W = ``max_len``, or ``min(window, max_len)`` for a local
    run) and an int32 ``pos`` of 0."""
    check_supported(cfg)
    runs = []
    for kind, _moe, _start, length in pattern_runs(cfg):
        w = min(cfg.window, max_len) if kind == "local" else max_len
        shape = (length, batch, w, cfg.n_kv, cfg.head_dim)
        runs.append({"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                     "v": torch.zeros(shape, dtype=cfg.dtype, device=device)})
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
    cache): the returned cache holds ``pos + 1`` and the same k/v tensors,
    into which this step's keys and values were written in place."""
    check_supported(cfg)
    pos = cache["pos"]
    x = _embed_tokens(params, cfg, tokens)
    for run_idx, (kind, _moe, _start, length) in enumerate(pattern_runs(cfg)):
        p_run, c_run = params["runs"][run_idx], cache["runs"][run_idx]
        rope = _run_rope(cfg, kind, pos.expand(tokens.shape[0], 1))
        w = c_run["k"].shape[2]
        slot = torch.remainder(pos, w).reshape(1).long()
        slot_pos = _slot_positions(pos, w)
        for i in range(length):
            p_l = _layer(p_run, i)
            x = x + _attn_decode(p_l, c_run["k"][i], c_run["v"][i], x, cfg,
                                 rope=rope, slot=slot, slot_pos=slot_pos,
                                 pos=pos)
            if cfg.mlp != "none":
                x = x + _mlp(p_l, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    return logits, dict(cache, pos=pos + 1)
