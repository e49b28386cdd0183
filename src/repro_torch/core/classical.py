"""Classical lossy compression baselines (paper Table 1 / Fig 10 rivals).

PyTorch counterpart of :mod:`repro.core.classical`: top-m coefficient
selection in three transform domains, with the same wire accounting as
the coresets (1 B index + 2 B quantized value per kept coefficient, per
channel):

* DCT-II (orthonormal, through an explicit (T, T) basis matmul),
* Haar DWT (as many doubling levels as T admits),
* Fourier (rFFT; complex coefficients cost two values).

Each takes one (T, C) window or a batch (..., T, C) and selects per
channel of each window.  A coefficient is kept where its magnitude is at
least the m-th largest, so ties keep more than m, as in the reference.
"""
from __future__ import annotations

import math

import torch

__all__ = ["dct_compress", "dwt_compress", "fourier_compress",
           "classical_payload_bytes"]


def _dct_basis(t: int, device=None) -> torch.Tensor:
    """The orthonormal (T, T) DCT-II basis, in float32 in the reference's
    order of operations."""
    n = torch.arange(t, dtype=torch.float32, device=device)
    k = n[:, None]
    basis = torch.cos(math.pi / t * (n[None, :] + 0.5) * k)
    lo, hi = (torch.sqrt(torch.tensor(v, dtype=torch.float32, device=device))
              for v in (1.0 / t, 2.0 / t))
    return basis * torch.where(k == 0, lo, hi)


def _topm_threshold(mag: torch.Tensor, m: int) -> torch.Tensor:
    """The m-th largest magnitude over the time axis (-2), per channel."""
    return torch.sort(mag, dim=-2, descending=True).values[..., m - 1:m, :]


def _topm_reconstruct(coeffs: torch.Tensor, m: int) -> torch.Tensor:
    """Zero all but the m largest-|.| coefficients (per channel)."""
    mag = coeffs.abs()
    return torch.where(mag >= _topm_threshold(mag, m), coeffs, 0.0)


def dct_compress(window: torch.Tensor, m: int) -> torch.Tensor:
    """(..., T, C) -> (..., T, C) reconstruction from m DCT coefficients a
    channel."""
    basis = _dct_basis(window.shape[-2], window.device)
    kept = _topm_reconstruct(basis @ window, m)
    return basis.T @ kept


def _haar_levels(t: int, max_levels: int = 8) -> int:
    lv = 0
    while t % 2 == 0 and lv < max_levels:
        t //= 2
        lv += 1
    return lv


def dwt_compress(window: torch.Tensor, m: int) -> torch.Tensor:
    """Haar DWT, top-m coefficients, inverse transform."""
    t, c = window.shape[-2:]
    levels = max(_haar_levels(t), 1)
    root2 = math.sqrt(2.0)
    s = window
    details = []
    for _ in range(levels):
        even, odd = s[..., 0::2, :], s[..., 1::2, :]
        details.append((even - odd) / root2)
        s = (even + odd) / root2
    kept = _topm_reconstruct(torch.cat([s] + details[::-1], dim=-2), m)
    # inverse
    off = s.shape[-2]
    s_rec = kept[..., :off, :]
    for d in details[::-1]:
        dd = kept[..., off:off + d.shape[-2], :]
        off += d.shape[-2]
        even = (s_rec + dd) / root2
        odd = (s_rec - dd) / root2
        s_rec = torch.stack([even, odd], dim=-2).reshape(
            even.shape[:-2] + (-1, c))
    return s_rec


def fourier_compress(window: torch.Tensor, m: int) -> torch.Tensor:
    """rFFT, keep m/2 complex coefficients (m real values), inverse."""
    t = window.shape[-2]
    coeffs = torch.fft.rfft(window, dim=-2)
    mag = coeffs.abs()
    kept = torch.where(mag >= _topm_threshold(mag, max(m // 2, 1)), coeffs,
                       torch.zeros_like(coeffs))
    return torch.fft.irfft(kept, n=t, dim=-2)


def classical_payload_bytes(m: int, bytes_index: int = 1,
                            bytes_value: int = 2) -> int:
    return m * (bytes_index + bytes_value)
