"""Data memoization via signature correlation (paper §3.2.1, decision D0).

PyTorch counterpart of :mod:`repro.core.memo`.  The fleet's batched hot
path is :func:`repro_torch.kernels.ops.signature_corr_op`; these plain
functions are the per-window definition it is tested against.
"""
from __future__ import annotations

import torch

__all__ = ["pearson", "signature_correlations"]


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
