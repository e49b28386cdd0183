"""Coreset construction — the heart of Seeker (paper §3.1).

PyTorch counterpart of :mod:`repro.core.coreset`.  The functions take one
window ``(T, C)`` or a batch ``(..., T, C)``; the batch form is the JAX
fleet's ``vmap`` over nodes written out.

* :func:`channel_cluster_coresets` builds every channel's k-means coreset
  of every window in ONE :func:`repro_torch.kernels.ops.kmeans_coreset_op`
  call over ``(N·C, T, 2)`` point clouds; :func:`kmeans_coreset` runs one
  cloud through the same op.
* :func:`importance_coreset` takes its Gumbel noise as a tensor of
  uniforms ``u`` instead of a PRNG key, so a test can hand it the numbers
  JAX drew; :func:`topk_importance_coreset` is its deterministic top-m
  twin, with no noise at all.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.ops import kmeans_coreset_op

__all__ = [
    "ClusterCoreset", "SamplingCoreset", "unit_grid", "points_from_window",
    "window_from_points", "channel_cluster_coresets", "kmeans_coreset",
    "importance_weights", "importance_coreset", "topk_importance_coreset",
    "quantize_uniform", "dequantize_uniform",
    "EncodedClusterCoreset", "encode_cluster_coreset",
    "decode_cluster_coreset", "raw_payload_bytes", "cluster_payload_bytes",
    "sampling_payload_bytes",
]


class ClusterCoreset(NamedTuple):
    """``centers`` (..., k, D), ``radii`` (..., k), ``counts`` (..., k)."""

    centers: torch.Tensor
    radii: torch.Tensor
    counts: torch.Tensor


class SamplingCoreset(NamedTuple):
    """``indices`` (..., m) ascending, ``values`` (..., m, C), ``weights``
    (..., m) inverse-probability weights, ``mean``/``var`` (..., C) moments
    of the full window."""

    indices: torch.Tensor
    values: torch.Tensor
    weights: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor


# ---------------------------------------------------------------------------
# Window <-> point-cloud plumbing
# ---------------------------------------------------------------------------

def unit_grid(t: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, t)`` in float32, value for value: ``i / (t-1)``."""
    if t == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    return torch.arange(t, dtype=torch.float32, device=device) / (t - 1)


def points_from_window(window: torch.Tensor,
                       time_scale: float | None = None) -> torch.Tensor:
    """Lift a (..., T, C) window to a (..., T, C+1) point cloud whose first
    coordinate is time, scaled by the window's peak-to-peak range."""
    if window.ndim == 1:
        window = window[:, None]
    t = window.shape[-2]
    if time_scale is None:
        ptp = window.amax(dim=(-2, -1)) - window.amin(dim=(-2, -1))
        time_scale = torch.clamp(ptp, min=1e-6)[..., None]
    tcoord = unit_grid(t, window.device) * time_scale
    return torch.cat([tcoord[..., None], window], dim=-1)


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` batched over the leading dims of ``xp``/
    ``fp`` (..., P), for a shared query grid ``x`` (Q,): the same
    searchsorted(side="right") bracket, the same flat-interval guard and
    constant extrapolation at both ends."""
    p = xp.shape[-1]
    xq = x.expand(xp.shape[:-1] + x.shape).contiguous()
    i = torch.clamp(torch.searchsorted(xp.contiguous(), xq, right=True),
                    1, p - 1)
    xp_lo, xp_hi = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp_lo, fp_hi = fp.gather(-1, i - 1), fp.gather(-1, i)
    df = fp_hi - fp_lo
    dx = xp_hi - xp_lo
    delta = xq - xp_lo
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp_lo,
                    fp_lo + (delta / torch.where(dx0, torch.ones_like(dx),
                                                 dx)) * df)
    f = torch.where(xq < xp[..., :1], fp[..., :1], f)
    return torch.where(xq > xp[..., -1:], fp[..., -1:], f)


def window_from_points(points: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of :func:`points_from_window`: stable-sort by the time
    coordinate and resample (..., P, 1+C) points onto a regular (..., T, C)
    grid by linear interpolation in time."""
    order = torch.argsort(points[..., 0], dim=-1, stable=True)
    pts = points.gather(-2, order[..., None].expand(points.shape))
    tc = pts[..., 0]
    src = (tc - tc[..., :1]) / torch.clamp(tc[..., -1:] - tc[..., :1],
                                           min=1e-9)
    grid = unit_grid(t, points.device)
    cols = [_interp(grid, src, pts[..., 1 + c])
            for c in range(points.shape[-1] - 1)]
    return torch.stack(cols, dim=-1)


def channel_cluster_coresets(window: torch.Tensor, k: int,
                             iters: int = 4) -> ClusterCoreset:
    """Per-channel 2-D (time, value) clustering coresets, the layout of the
    paper's per-channel FIFO hardware.  A (T, C) window gives centers
    (C, k, 2), radii (C, k), counts (C, k); a (N, T, C) batch adds the
    leading N.  Every cloud of the batch goes through one
    :func:`kmeans_coreset_op` call."""
    if window.ndim == 1:
        window = window[:, None]
    lead, (t, c) = window.shape[:-2], window.shape[-2:]
    cols = window.transpose(-1, -2)[..., None]            # (..., C, T, 1)
    pts = points_from_window(cols).reshape(-1, t, 2).contiguous()
    centers, radii, counts = kmeans_coreset_op(pts, k, iters)
    return ClusterCoreset(centers=centers.reshape(lead + (c, k, 2)),
                          radii=radii.reshape(lead + (c, k)),
                          counts=counts.reshape(lead + (c, k)))


def kmeans_coreset(points: torch.Tensor, k: int,
                   iters: int = 4) -> ClusterCoreset:
    """Lloyd's k-means with a fixed iteration budget (paper: 4) on one
    (N, D) point cloud (:func:`points_from_window` lifts a window to one),
    from the evenly strided init
    (:func:`repro_torch.kernels.ref.kmeans_init_centers`): centers (k, D),
    radii (k,) and int32 counts (k,).  One :func:`kmeans_coreset_op`
    launch; argmin ties go to the lower cluster index, as ``jnp.argmin``'s
    do."""
    centers, radii, counts = kmeans_coreset_op(
        points.to(torch.float32)[None].contiguous(), k, iters)
    return ClusterCoreset(centers=centers[0], radii=radii[0],
                          counts=counts[0])


# ---------------------------------------------------------------------------
# Importance-sampling coreset
# ---------------------------------------------------------------------------

def _median_flat(x: torch.Tensor) -> torch.Tensor:
    """Median over the last two dims, averaging the two middle values for
    an even count like ``jnp.median`` (``torch.median`` takes the lower)."""
    flat = torch.sort(x.flatten(-2), dim=-1).values
    n = flat.shape[-1]
    lo, hi = flat[..., (n - 1) // 2], flat[..., n // 2]
    return (lo + hi) * 0.5


def importance_weights(window: torch.Tensor,
                       spread: float = 0.25) -> torch.Tensor:
    """Importance of each sample: magnitude of the mean-detrended signal
    plus its share of the dominant spectral bands, blended with a
    ``spread`` uniform floor.  (..., T, C) -> (..., T)."""
    if window.ndim == 1:
        window = window[:, None]
    t = window.shape[-2]
    detrended = window - window.mean(dim=-2, keepdim=True)
    mag = detrended.abs().sum(dim=-1)
    spec = torch.fft.rfft(detrended, dim=-2).abs()
    med = _median_flat(spec)[..., None, None]
    masked = spec * (spec > med).to(spec.dtype)
    envelope = torch.fft.irfft(masked.to(torch.complex64), n=t,
                               dim=-2).abs().sum(dim=-1)
    w = mag + envelope
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    uniform = torch.full((t,), 1.0 / t, dtype=w.dtype, device=w.device)
    return (1.0 - spread) * w + spread * uniform


def importance_coreset(window: torch.Tensor, m: int, u: torch.Tensor,
                       spread: float = 0.25) -> SamplingCoreset:
    """Weighted sampling without replacement of ``m`` points by the
    Gumbel-top-k trick.  ``u`` (..., T) holds the uniforms in [1e-9, 1)
    that ``jax.random.uniform`` draws at ``repro/core/coreset.py:230``."""
    if window.ndim == 1:
        window = window[:, None]
    w = importance_weights(window, spread=spread)
    g = -torch.log(-torch.log(u))
    scores = torch.log(torch.clamp(w, min=1e-12)) + g
    idx = torch.sort(torch.topk(scores, m, dim=-1).indices, dim=-1).values
    return _sampling_coreset(window, w, idx, m)


def topk_importance_coreset(window: torch.Tensor, m: int,
                            spread: float = 0.25) -> SamplingCoreset:
    """Deterministic variant: the m largest importance weights, what the
    paper's fixed-function sampler computes when no RNG is available.
    Equal weights go to the lower index, as ``jax.lax.top_k``'s do (a
    stable descending sort; ``torch.topk`` orders ties arbitrarily)."""
    if window.ndim == 1:
        window = window[:, None]
    w = importance_weights(window, spread=spread)
    top = torch.sort(w, dim=-1, descending=True, stable=True).indices
    idx = torch.sort(top[..., :m], dim=-1).values
    return _sampling_coreset(window, w, idx, m)


def _sampling_coreset(window: torch.Tensor, w: torch.Tensor,
                      idx: torch.Tensor, m: int) -> SamplingCoreset:
    """The picked samples ``idx`` (..., m) of (..., T, C) windows with
    their Horvitz-Thompson weights ``1 / (m w)`` and the full windows'
    moments."""
    mean = window.mean(dim=-2)
    var = ((window - window.mean(dim=-2, keepdim=True)) ** 2).mean(dim=-2)
    values = window.gather(
        -2, idx[..., None].expand(idx.shape + window.shape[-1:]))
    weights = 1.0 / torch.clamp(m * w.gather(-1, idx), min=1e-9)
    return SamplingCoreset(indices=idx.to(torch.int32), values=values,
                           weights=weights, mean=mean, var=var)


# ---------------------------------------------------------------------------
# Quantized wire encoding (paper §3.2, §4)
# ---------------------------------------------------------------------------

def _range(hi, lo) -> torch.Tensor:
    """``max(hi - lo, 1e-9)`` in float32, for tensor or float bounds."""
    return torch.clamp(torch.as_tensor(hi - lo, dtype=torch.float32),
                       min=1e-9)


def quantize_uniform(x: torch.Tensor, bits: int, lo, hi) -> torch.Tensor:
    """Uniform quantization of ``x`` clipped to ``[lo, hi]`` to ``bits``
    bits; int32 codes, rounded half to even like ``jnp.round``."""
    levels = (1 << bits) - 1
    lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    xc = torch.clamp(x, lo_t, hi_t)
    scale = _range(hi_t, lo_t)
    return torch.round((xc - lo_t) / scale * levels).to(torch.int32)


def dequantize_uniform(codes: torch.Tensor, bits: int, lo,
                       hi) -> torch.Tensor:
    levels = (1 << bits) - 1
    scale = _range(torch.as_tensor(hi, dtype=torch.float32,
                                   device=codes.device),
                   torch.as_tensor(lo, dtype=torch.float32,
                                   device=codes.device))
    return codes.to(torch.float32) / levels * scale + lo


class EncodedClusterCoreset(NamedTuple):
    """The wire format of Table/§3.2: per cluster 2 B center + 1 B radius +
    4 bit count, plus a (lo, hi) range pair shared by the whole payload."""

    center_codes: torch.Tensor  # (k, D) int32, center_bits / D bits a dim
    radius_codes: torch.Tensor  # (k,) int32, 8-bit
    counts: torch.Tensor        # (k,) int32, 4-bit on the wire
    lo: torch.Tensor
    hi: torch.Tensor


def encode_cluster_coreset(cs: ClusterCoreset, center_bits: int = 16,
                           radius_bits: int = 8) -> EncodedClusterCoreset:
    """Quantize one coreset: centers over their (min, max) range, radii
    over ``[0, max radius]``."""
    d = cs.centers.shape[-1]
    per_dim_bits = max(center_bits // d, 1)
    lo = cs.centers.min()
    hi = cs.centers.max()
    center_codes = quantize_uniform(cs.centers, per_dim_bits, lo, hi)
    rhi = torch.clamp(cs.radii.max(), min=1e-9)
    radius_codes = quantize_uniform(cs.radii, radius_bits, 0.0, rhi)
    return EncodedClusterCoreset(center_codes, radius_codes, cs.counts, lo,
                                 rhi * 0 + hi)


def decode_cluster_coreset(enc: EncodedClusterCoreset, center_bits: int = 16,
                           radius_bits: int = 8) -> ClusterCoreset:
    """Dequantize; the radius range is taken as ``hi - lo`` (the wire
    carries one range pair), as the reference does."""
    d = enc.center_codes.shape[-1]
    per_dim_bits = max(center_bits // d, 1)
    centers = dequantize_uniform(enc.center_codes, per_dim_bits, enc.lo,
                                 enc.hi)
    rhi = _range(enc.hi, enc.lo)
    radii = dequantize_uniform(enc.radius_codes, radius_bits, 0.0, rhi)
    return ClusterCoreset(centers=centers, radii=radii, counts=enc.counts)


# ---------------------------------------------------------------------------
# Byte accounting (paper §3.2, §4)
# ---------------------------------------------------------------------------

def raw_payload_bytes(t: int, bytes_per_value: int = 4) -> int:
    """Paper: 60 fp32 points = 240 B."""
    return t * bytes_per_value


def cluster_payload_bytes(k: int, bytes_center: int = 2, bytes_radius: int = 1,
                          bits_count: int = 4, recoverable: bool = True) -> int:
    """Paper: 12 clusters -> 36 B; +4 bit/cluster counts -> 42 B."""
    base = k * (bytes_center + bytes_radius)
    if recoverable:
        base += math.ceil(k * bits_count / 8)
    return base


def sampling_payload_bytes(m: int, bytes_index: int = 1, bytes_value: int = 2,
                           with_moments: bool = True, bytes_moment: int = 2,
                           channels: int = 1) -> int:
    """m selected points (1 B index + 2 B per channel) + per-channel
    mean/var when the recovery conditioning is shipped."""
    base = m * (bytes_index + bytes_value * channels)
    if with_moments:
        base += 2 * bytes_moment * channels
    return base
