"""Flash-style exact attention with a recompute backward.

PyTorch counterpart of :mod:`repro.models.flash`: each walk is a
``torch.autograd.Function`` whose forward runs :mod:`.layers`' walk
(the running max and sum in float32, the PV product in the input dtype)
and saves only ``(q, k, v, out, lse)``; its backward re-walks the same
chunk pairs or bands in the same order, recomputing the probabilities from
the row log-sum-exp.  The backward accumulates dq, dk and dv in float32,
takes ``delta = sum(dout * out)`` in float32, casts ``ds`` and ``p`` to the
query's dtype before its three products, and applies the soft-cap's chain
rule, as the reference's ``custom_vjp`` does.  Neither walk is itself
differentiated, so no walk state is saved.

* :func:`flash_causal_attention` — lower-triangular chunk-pair walk
  (FLOPs = T(T+1)/2 pairs; no masked-garbage compute).
* :func:`flash_banded_attention` — sliding-window band walk
  (FLOPs ~ S*(window+chunk)), the KV left-padded by ``window``.

Shapes follow layers.py: q (B,S,G,R,D), k/v (B,T,G,D).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import NEG_INF, _band_mask
from .layers import _banded_walk as _banded_fwd_walk
from .layers import _causal_walk as _causal_fwd_walk

__all__ = ["flash_causal_attention", "flash_banded_attention"]


def _capped_scores(qi, kj, scale: float, softcap: float):
    """float32 scores and, with a soft-cap, ``tanh(raw / softcap)`` (the
    chain rule's factor), before any mask."""
    raw = torch.einsum("bsgrd,btgd->bgrst", qi, kj).float() * scale
    if softcap > 0.0:
        capped = torch.tanh(raw / softcap)
        return capped * softcap, capped
    return raw, None


def _pair_grads(qi, kj, vj, doi, lse_i, del_i, mask, scale: float,
                softcap: float):
    """One (query chunk, key chunk or band) pair's contributions to dq, dk
    and dv, each in the query's dtype.  ``mask`` None means no key of the
    pair is masked."""
    scores, capped = _capped_scores(qi, kj, scale, softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.exp(scores - lse_i[..., None])                  # (b,g,r,s,t)
    dp = torch.einsum("bsgrd,btgd->bgrst", doi, vj).float()
    ds = p * (dp - del_i[..., None])
    if capped is not None:
        ds = ds * (1.0 - capped ** 2)                         # softcap chain
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    ds = (ds * scale).to(qi.dtype)
    dq = torch.einsum("bgrst,btgd->bsgrd", ds, kj)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds, qi)
    dv = torch.einsum("bgrst,bsgrd->btgd", p.to(qi.dtype), doi)
    return dq, dk, dv


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``sum(dout * out)`` over the head dim in float32, as (b,g,r,s)."""
    return (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 3, 1)


def _causal_bwd_walk(q, k, v, out, lse, dout, chunk: int, softcap: float):
    b, s, g, r, d = q.shape
    scale = 1.0 / math.sqrt(d)
    delta = _delta(dout, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    for i in range(s // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        qi, doi = q[:, rows], dout[:, rows]
        lse_i, del_i = lse[..., rows], delta[..., rows]
        for j in range(i + 1):
            cols = slice(j * chunk, (j + 1) * chunk)
            dq_i, dk_j, dv_j = _pair_grads(
                qi, k[:, cols], v[:, cols], doi, lse_i, del_i,
                causal if j == i else None, scale, softcap)
            dq[:, rows] += dq_i.float()
            dk[:, cols] += dk_j.float()
            dv[:, cols] += dv_j.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _banded_bwd_walk(q, k, v, out, lse, dout, window: int, chunk: int,
                     softcap: float):
    b, s, g, r, d = q.shape
    band = window + chunk
    scale = 1.0 / math.sqrt(d)
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    delta = _delta(dout, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkp = torch.zeros(kp.shape, dtype=torch.float32, device=q.device)
    dvp = torch.zeros(vp.shape, dtype=torch.float32, device=q.device)
    for i in range(s // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        cols = slice(i * chunk, i * chunk + band)
        dq_i, dk_b, dv_b = _pair_grads(
            q[:, rows], kp[:, cols], vp[:, cols], dout[:, rows],
            lse[..., rows], delta[..., rows],
            _band_mask(i, chunk, window, q.device), scale, softcap)
        dq[:, rows] = dq_i.float()
        dkp[:, cols] += dk_b.float()
        dvp[:, cols] += dv_b.float()
    return (dq.to(q.dtype), dkp[:, window:].to(k.dtype),
            dvp[:, window:].to(v.dtype))


class _FlashCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, chunk: int, softcap: float):
        out, lse = _causal_fwd_walk(q, k, v, chunk, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunk, ctx.softcap = chunk, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _causal_bwd_walk(*ctx.saved_tensors, dout.contiguous(),
                                 ctx.chunk, ctx.softcap)
        return (*grads, None, None)


class _FlashBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window: int, chunk: int, softcap: float):
        out, lse = _banded_fwd_walk(q, k, v, window, chunk, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.chunk, ctx.softcap = window, chunk, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _banded_bwd_walk(*ctx.saved_tensors, dout.contiguous(),
                                 ctx.window, ctx.chunk, ctx.softcap)
        return (*grads, None, None, None)


def flash_causal_attention(q, k, v, chunk: int = 512,
                           softcap: float = 0.0) -> torch.Tensor:
    """Causal attention by the lower-triangular chunk-pair walk."""
    return _FlashCausal.apply(q, k, v, chunk, softcap)


def flash_banded_attention(q, k, v, window: int, chunk: int = 512,
                           softcap: float = 0.0) -> torch.Tensor:
    """Sliding-window attention by the per-chunk KV-band walk."""
    return _FlashBanded.apply(q, k, v, window, chunk, softcap)
