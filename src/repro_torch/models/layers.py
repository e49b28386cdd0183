"""Shared transformer layers: norms, gated activations, RoPE and M-RoPE,
sinusoidal positions, attention.

PyTorch counterpart of :mod:`repro.models.layers`, in the same order of
operations and dtypes: the norms and the softmax compute in float32, score
tensors are taken to float32 after their matmul, and the probabilities are
cast to the query's dtype before the PV product.  Attention comes in four execution shapes, chosen by the caller:

* :func:`dense_attention`        — materialized scores, causal or not; short
  sequences, the encoder and cross-attention.
* :func:`pair_chunked_attention` — causal online softmax over the lower
  triangle of chunk pairs only (exact, about half the FLOPs of a full walk).
* :func:`banded_attention`       — sliding-window attention over per-chunk
  KV bands: FLOPs scale with S*(window+chunk), not S^2.
* :func:`decode_attention`       — one query step against a ring or linear
  KV cache, masked by the global position each slot holds.

All attention functions take q (B,S,G,R,D) and k/v (B,T,G,D): GQA is the
(G = kv heads, R = q heads per kv head) split, so repeated K/V are never
materialized.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm", "swiglu", "geglu", "rope_sincos", "apply_rope",
    "mrope_sincos", "apply_mrope", "sinusoidal_positions", "sinusoidal_at",
    "dense_attention", "pair_chunked_attention", "banded_attention",
    "decode_attention", "NEG_INF",
]

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale``, back in ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.gelu(gate, approximate="tanh") * up


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freq(theta: float, half: int, device) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` in float32."""
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=device) / half)


def rope_sincos(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> sin/cos (..., S, head_dim//2), frequencies
    ``theta ** (-arange(half) / half)`` in float32."""
    freq = _rope_freq(theta, head_dim // 2, positions.device)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B, S, D/2) — rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_sincos(positions: torch.Tensor, sections: tuple[int, ...],
                 head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's multimodal RoPE tables: ``positions`` (3, B, S) carries
    (temporal, h, w) ids, and ``sections`` split the half-dim's
    frequencies among the three components (sum(sections) == head_dim //
    2).  Returns sin/cos (B, S, head_dim//2) for :func:`apply_rope`."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freq = _rope_freq(theta, half, positions.device)
    angs, lo = [], 0
    for comp, sec in enumerate(sections):
        angs.append(positions[comp].float()[..., None] * freq[lo:lo + sec])
        lo += sec
    ang = torch.cat(angs, dim=-1)
    return torch.sin(ang), torch.cos(ang)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by M-RoPE at ``positions`` (3, B, S)."""
    return apply_rope(x, *mrope_sincos(positions, sections, x.shape[-1],
                                       theta))


def _sinusoid_freq(d: int, device) -> torch.Tensor:
    half = d // 2
    return torch.exp(-math.log(10000.0) * torch.arange(half, device=device)
                     / (half - 1))


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embedding table (n, d), float32:
    sin then cos of ``position * 10000 ** (-i / (d/2 - 1))``."""
    freq = _sinusoid_freq(d, device)
    ang = torch.arange(n, device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding at ``positions`` (...,) -> (..., d),
    float32; the decoder's absolute positions when RoPE is off
    (whisper)."""
    ang = positions.float()[..., None] * _sinusoid_freq(d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention bodies
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            softcap: float) -> torch.Tensor:
    """(B,S,G,R,D) x (B,T,G,D) -> float32 scores (B,G,R,S,T), taken to
    float32 before the scale, then soft-capped (before any mask)."""
    s = torch.einsum("bsgrd,btgd->bgrst", q, k).float() * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    return s


def _pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bgrst,btgd->bsgrd", probs, v)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Materialized-score attention, causal (query i sees keys <= i) or
    not.  q (B,S,G,R,D); k,v (B,T,G,D)."""
    s, d = q.shape[1], q.shape[-1]
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    # the scale multiplies in q's dtype here, before the float32 cast
    scores = (torch.einsum("bsgrd,btgd->bgrst", q, k) * scale).float()
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap   # BEFORE masking
    qpos = torch.arange(s, device=q.device)
    kpos = torch.arange(t, device=q.device)
    mask = qpos[:, None] >= kpos[None, :] if causal else None
    if window is not None:
        near = (qpos[:, None] - kpos[None, :]) < window
        mask = near if mask is None else mask & near
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _pv(probs, v)


def _causal_walk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 chunk: int, softcap: float):
    """The lower-triangular chunk-pair walk: (output, row log-sum-exp
    (B,G,R,S) float32)."""
    b, s, g, r, d = q.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((b, g, r, s), device=q.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    for i in range(s // chunk):
        qi = q[:, i * chunk:(i + 1) * chunk]
        m = torch.full((b, g, r, chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, g, r, chunk), device=q.device)
        acc = torch.zeros((b, chunk, g, r, d), device=q.device)
        for j in range(i + 1):
            kj = k[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            scores = _scores(qi, kj, scale, softcap)
            if j == i:          # only the diagonal pair holds masked keys
                scores = torch.where(causal, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = _pv(p.to(q.dtype), vj).float()
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, i * chunk:(i + 1) * chunk] = (
            acc / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype)
        lse[..., i * chunk:(i + 1) * chunk] = m + torch.log(l)
    return out, lse


def pair_chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, chunk: int = 512,
                           softcap: float = 0.0) -> torch.Tensor:
    """Exact causal attention walking ONLY the lower-triangular chunk pairs.

    The pairs (i, j), j <= i, are walked in row-major order, carrying the
    online-softmax state (m, l, acc) of the current query row in float32;
    a row's normalized result is written when its last pair (j == i) is
    done.  FLOPs match T(T+1)/2 chunk pairs.  The flash causal walk is
    this walk.
    """
    return _causal_walk(q, k, v, chunk, softcap)[0]


def _band_mask(i: int, chunk: int, window: int, device) -> torch.Tensor:
    """(chunk, window + chunk) validity of query chunk ``i``'s KV band."""
    qpos = i * chunk + torch.arange(chunk, device=device)
    kpos = i * chunk - window + torch.arange(window + chunk, device=device)
    return ((kpos[None, :] >= 0) & (qpos[:, None] >= kpos[None, :])
            & (qpos[:, None] - kpos[None, :] < window))


def _banded_walk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, chunk: int, softcap: float):
    """The per-chunk KV-band walk: (output, row log-sum-exp (B,G,R,S)
    float32)."""
    b, s, g, r, d = q.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    scale = 1.0 / math.sqrt(d)
    band = window + chunk
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    outs, lses = [], []
    for i in range(s // chunk):
        scores = _scores(q[:, i * chunk:(i + 1) * chunk],
                         kp[:, i * chunk:i * chunk + band], scale, softcap)
        scores = torch.where(_band_mask(i, chunk, window, q.device), scores,
                             NEG_INF)
        # the softmax spelled out: exp(s - max) over its clamped sum
        m = scores.amax(dim=-1)
        p = torch.exp(scores - m[..., None])
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        outs.append(_pv((p / l[..., None]).to(q.dtype),
                        vp[:, i * chunk:i * chunk + band]))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, chunk: int = 512,
                     softcap: float = 0.0) -> torch.Tensor:
    """Sliding-window causal attention with FLOPs ~ S*(window+chunk).

    Each query chunk i attends to the KV band [i*chunk - window,
    i*chunk + chunk) of a KV left-padded by ``window`` zeros, so no
    O(S^2) score tensor ever exists.  The flash banded walk is this walk.
    """
    return _banded_walk(q, k, v, window, chunk, softcap)[0]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     pos: torch.Tensor, *, window: int | None = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """One query step vs a cache.  q (B,1,G,R,D); caches (B,W,G,D);
    slot_pos (W,) int32 holds the *global* position stored in each slot
    (-1 = empty) so both linear and ring caches use the same masking."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _scores(q, k_cache, scale, softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= (pos - slot_pos) < window
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _pv(probs, v_cache)
