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

__all__ = ["kmeans_init_centers", "kmeans_coreset_ref",
           "importance_select_ref", "signature_corr_ref", "fake_quant_ref",
           "fake_quant_scale"]


def kmeans_init_centers(points: torch.Tensor, k: int) -> torch.Tensor:
    """The evenly strided init of ``repro.core.coreset._init_centers``:
    points ``(i * N) // k`` for i < k of each (..., N, D) cloud, with no RNG
    on the sensor.  The CUDA kernel starts from the same points."""
    n = points.shape[-2]
    return points[..., (torch.arange(k, device=points.device) * n) // k, :]


def kmeans_coreset_ref(points: torch.Tensor, k: int, iters: int = 4):
    """Batched Lloyd with strided init and a fixed iteration budget.

    points (B, N, D) float32 -> (centers (B,k,D), radii (B,k),
    counts (B,k) int32).  An empty cluster keeps its centre; argmin ties go
    to the lowest index."""
    centers = kmeans_init_centers(points, k)                # (B, k, D)
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


def importance_select_ref(windows: torch.Tensor, m: int, spread: float = 0.25,
                          avg_width: int = 8):
    """Deterministic top-m importance selection: the hardware sampler.

    windows (B, T, C) float32 -> (indices (B, m) int32 ascending, values
    (B, m, C), Horvitz-Thompson weights (B, m)).  Each sample's score is its
    deviation from an edge-padded ``avg_width``-tap box moving average,
    summed over channels, normalised per window and blended with a
    ``spread`` uniform floor; the m best are kept, ties to the lower index.

    The arithmetic is in the order of the Pallas body
    (``repro.kernels.importance_select._select_kernel``), which the CUDA
    kernel repeats: the shifted slices added j = 0..w-1, the channel sum
    c = 0..C-1 and the normalising sum t = 0..T-1, each in sequence.  The
    selection is a stable descending sort, so equal scores go to the lower
    index, as ``lax.top_k`` gives them."""
    b, t, c = windows.shape
    pad_l = avg_width // 2
    pad_r = avg_width - 1 - pad_l
    xp = torch.cat([windows[:, :1].expand(b, pad_l, c), windows,
                    windows[:, -1:].expand(b, pad_r, c)], dim=1)
    acc = torch.zeros_like(windows)
    for j in range(avg_width):
        acc = acc + xp[:, j:j + t]
    dev = (windows - acc / avg_width).abs()
    detr = dev[..., 0]
    for ci in range(1, c):
        detr = detr + dev[..., ci]                          # (B, T)
    total = torch.zeros_like(detr[:, 0])
    for ti in range(t):
        total = total + detr[:, ti]
    w = detr / torch.clamp(total, min=1e-9)[:, None]
    w = (1.0 - spread) * w + spread / t
    order = torch.sort(w, dim=-1, descending=True, stable=True).indices
    idx = torch.sort(order[:, :m], dim=-1).values
    vals = torch.gather(windows, 1, idx[..., None].expand(b, m, c))
    weights = 1.0 / torch.clamp(m * torch.gather(w, 1, idx), min=1e-9)
    return idx.to(torch.int32), vals, weights


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
