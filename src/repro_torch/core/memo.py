"""Data memoization via signature correlation (paper §3.2.1, decision D0).

PyTorch counterpart of :mod:`repro.core.memo`.  :func:`memo_decision`
runs the batched hot path, :func:`repro_torch.kernels.ops.signature_corr_op`
(the kernel on the card, its plain version on the CPU); the plain functions
:func:`pearson` and :func:`signature_correlations` are the per-window
definition it is tested against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.ops import signature_corr_op

__all__ = ["pearson", "signature_correlations", "memo_decision", "MemoResult"]


def pearson(a: torch.Tensor, b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pearson correlation along ``axis`` (broadcasting elsewhere)."""
    am = a - a.mean(dim=axis, keepdim=True)
    bm = b - b.mean(dim=axis, keepdim=True)
    num = (am * bm).sum(dim=axis)
    den = torch.sqrt((am * am).sum(dim=axis) * (bm * bm).sum(dim=axis))
    return num / torch.clamp(den, min=1e-9)


def signature_correlations(window: torch.Tensor,
                           signatures: torch.Tensor) -> torch.Tensor:
    """Correlate a (T, C) window against an (L, T, C) signature bank:
    per-channel Pearson correlations averaged across channels -> (L,)."""
    if window.ndim == 1:
        window = window[:, None]
    if signatures.ndim == 2:
        signatures = signatures[:, :, None]
    corr = pearson(signatures, window[None], axis=1)   # (L, C)
    return corr.mean(dim=-1)


class MemoResult(NamedTuple):
    """Per window: ``hit`` (bool) a signature cleared the threshold,
    ``label`` (int32) the best signature, valid iff ``hit``, and
    ``max_corr`` (float32) its coefficient; () for one window, (N,) for a
    batch."""

    hit: torch.Tensor
    label: torch.Tensor
    max_corr: torch.Tensor


def memo_decision(window: torch.Tensor, signatures: torch.Tensor,
                  threshold: float = 0.95) -> MemoResult:
    """The D0 gate of the paper's decision flow (Fig. 8, steps 1a/1b) for a
    (T, C) window or a batch (N, T, C), against an (L, T, C) bank; one
    :func:`signature_corr_op` call.  Ties go to the lower signature index,
    as ``jnp.argmax``'s do."""
    if window.ndim == 1:
        window = window[:, None]
    if signatures.ndim == 2:
        signatures = signatures[:, :, None]
    batched = window.ndim == 3
    wins = window if batched else window[None]
    corr = signature_corr_op(wins.to(torch.float32).contiguous(),
                             signatures.to(torch.float32).contiguous())
    best = torch.argmax(corr, dim=-1)
    max_corr = corr.gather(-1, best[:, None])[:, 0]
    res = MemoResult(hit=max_corr >= threshold, label=best.to(torch.int32),
                     max_corr=max_corr)
    return res if batched else MemoResult(*(x[0] for x in res))
