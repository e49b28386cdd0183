"""Plain PyTorch versions of the hand-written CUDA kernels.

Counterpart of :mod:`repro.kernels.ref`: each function here is the
definition a kernel in ``csrc/`` is held against, in float32, with the
kernel's algorithmic choices (fixed iteration budget, strided init, amax
outside the quantizer).  :mod:`repro_torch.kernels.ops` runs these for
tensors that lie on the CPU; ``chip_smoke.py`` compares each kernel with
its plain version on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["kmeans_coreset_ref", "signature_corr_ref", "fake_quant_ref",
           "fake_quant_scale"]


def kmeans_coreset_ref(points: torch.Tensor, k: int, iters: int = 4):
    """Batched Lloyd with strided init and a fixed iteration budget.

    points (B, N, D) float32 -> (centers (B,k,D), radii (B,k),
    counts (B,k) int32).  An empty cluster keeps its centre; argmin ties go
    to the lowest index."""
    b, n, d = points.shape
    stride_idx = (torch.arange(k, device=points.device) * n) // k
    centers = points[:, stride_idx, :]                      # (B, k, D)
    for _ in range(iters):
        d2 = ((points[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
        assign = torch.argmin(d2, dim=-1)                   # (B, N)
        onehot = F.one_hot(assign, k).to(points.dtype)      # (B, N, k)
        counts = onehot.sum(dim=1)                          # (B, k)
        sums = torch.einsum("bnk,bnd->bkd", onehot, points)
        centers = torch.where(counts[..., None] > 0,
                              sums / torch.clamp(counts[..., None], min=1.0),
                              centers)
    d2 = ((points[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    assign = torch.argmin(d2, dim=-1)
    onehot = F.one_hot(assign, k).to(points.dtype)
    counts = onehot.sum(dim=1).to(torch.int32)
    dist = torch.sqrt(torch.gather(d2, -1, assign[..., None])[..., 0])
    radii = (onehot * dist[..., None]).amax(dim=1)
    return centers, radii, counts


def signature_corr_ref(windows: torch.Tensor,
                       signatures: torch.Tensor) -> torch.Tensor:
    """Batched per-channel Pearson correlation, averaged over channels.
    windows (B, T, C), signatures (L, T, C) -> (B, L)."""
    wm = windows - windows.mean(dim=1, keepdim=True)
    sm = signatures - signatures.mean(dim=1, keepdim=True)
    num = torch.einsum("btc,ltc->blc", wm, sm)
    wn = torch.sqrt((wm * wm).sum(dim=1))                   # (B, C)
    sn = torch.sqrt((sm * sm).sum(dim=1))                   # (L, C)
    den = wn[:, None, :] * sn[None, :, :]
    return (num / torch.clamp(den, min=1e-9)).mean(dim=-1)


def fake_quant_scale(x2d: torch.Tensor, bits: int, per_channel: bool,
                     rows_per_group: int) -> torch.Tensor:
    """The quantizer's scale ``max(amax, 1e-9) / qmax`` for a (R, C) tensor:
    one per last-dim channel (shape (C,)), or one per group of
    ``rows_per_group`` consecutive rows (shape (R // rows_per_group,)).
    A per-tensor scale is the one-group case.

    The division by the constant ``qmax`` is a multiply by its float32
    reciprocal, which is what XLA compiles the JAX package's division to;
    a true division differs from it by an ulp for some amax, and that ulp
    moves an element that sits on a rounding boundary by a whole level."""
    qmax = 2.0 ** (bits - 1) - 1.0
    a = x2d.abs()
    if per_channel:
        amax = a.amax(dim=0)
    else:
        amax = a.reshape(-1, rows_per_group * x2d.shape[1]).amax(dim=1)
    return torch.clamp(amax, min=1e-9) * float(np.float32(1.0) / np.float32(qmax))


def fake_quant_ref(x2d: torch.Tensor, scale: torch.Tensor, bits: int,
                   per_channel: bool, rows_per_group: int) -> torch.Tensor:
    """Symmetric quantize-dequantize ``clip(round(x / s), ±qmax) * s`` of a
    (R, C) tensor with the scale layout of :func:`fake_quant_scale`.
    ``round`` is half-to-even, like ``jnp.round``."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if per_channel:
        s = scale[None, :]
    else:
        s = scale.repeat_interleave(rows_per_group)[:, None]
    return torch.clamp(torch.round(x2d / s), -qmax, qmax) * s
