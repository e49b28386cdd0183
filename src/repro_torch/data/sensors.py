"""Synthetic HAR sensor data (MHEALTH-like), drawn with ``torch.Generator``.

PyTorch counterpart of the HAR part of :mod:`repro.data.sensors`: the same
signal family (a shared quasi-periodic gait component plus three weak
class-coded transient events per window, instance jitter and sensor
noise), generated batched on the generator's device so a fleet's streams
are made in bulk.  The numbers match the JAX generators in distribution,
not value for value; parity tests feed both packages the same arrays.
"""
from __future__ import annotations

import math

import torch

__all__ = ["har_window", "har_windows", "har_stream", "class_signatures"]

_N_HARM = 14


def _class_params(n_classes: int, channels: int, t: int, device):
    """Deterministic per-class event positions, widths and signed
    amplitudes (drawn from a fixed seed, like the JAX package's fixed key)."""
    g = torch.Generator().manual_seed(1234)
    lo, hi = int(0.10 * t), int(0.90 * t)
    pos = torch.round(lo + (hi - lo) * torch.rand((n_classes, 3), generator=g))
    width = 0.8 + 1.2 * torch.rand((n_classes, 3), generator=g)
    amp = 0.45 + 0.25 * torch.rand((n_classes, 3, channels), generator=g)
    sign = torch.sign(torch.randn((n_classes, 3, channels), generator=g))
    return pos.to(device), width.to(device), (amp * sign).to(device)


def har_windows(generator: torch.Generator, labels: torch.Tensor,
                t: int = 60, channels: int = 3, n_classes: int = 12,
                fs: float = 50.0, noise: float = 0.12) -> torch.Tensor:
    """(B, T, C) windows, one of each class in ``labels`` (B,)."""
    dev = generator.device
    labels = labels.to(dev).long()
    b = labels.shape[0]
    pos, width, amp = _class_params(n_classes, channels, t, dev)
    tgrid = torch.arange(t, device=dev, dtype=torch.float32) / fs
    idx = torch.arange(t, device=dev, dtype=torch.float32)

    # shared dominant gait component: a rich quasi-periodic spectrum with
    # instance-jittered phases
    hphase = (2.3 * torch.arange(_N_HARM, device=dev)[None, :, None]
              + 0.35 * torch.randn((b, _N_HARM, channels), generator=generator,
                                   device=dev))
    base = torch.zeros((b, t, channels), device=dev)
    for h in range(_N_HARM):
        freq = 0.8 * (1 + h * 0.72)
        amp_h = 1.0 / (1.0 + 0.28 * h)
        base = base + amp_h * torch.sin(
            2 * math.pi * freq * tgrid[None, :, None] + hphase[:, None, h, :])
    base = base / 2.0

    # three weak class-coded transient events with +-1 sample jitter
    jit = torch.randint(-1, 2, (b, 3), generator=generator,
                        device=dev).to(torch.float32)
    amp_jit = 1.0 + 0.15 * torch.randn((b, channels), generator=generator,
                                       device=dev)
    sig = base
    for e in range(3):
        centre = pos[labels, e] + jit[:, e]
        ev = torch.exp(-0.5 * ((idx[None, :] - centre[:, None])
                               / width[labels, e][:, None]) ** 2)
        sig = sig + ev[..., None] * (amp[labels, e] * amp_jit)[:, None, :]
    return sig + noise * torch.randn((b, t, channels), generator=generator,
                                     device=dev)


def har_window(generator: torch.Generator, label: int, t: int = 60,
               channels: int = 3, n_classes: int = 12, fs: float = 50.0,
               noise: float = 0.12) -> torch.Tensor:
    """One (T, C) window of the given activity class."""
    labels = torch.tensor([label], device=generator.device)
    return har_windows(generator, labels, t, channels, n_classes, fs,
                       noise)[0]


def har_stream(generator: torch.Generator, n: int, t: int = 60,
               channels: int = 3, n_classes: int = 12, dwell: int = 8,
               streams: int | None = None):
    """A stream of ``n`` windows whose activity changes only every
    ``dwell`` windows (the paper's AAC premise).  Returns (windows (n, T, C),
    labels (n,)); with ``streams=N``, N independent streams (N, n, T, C) and
    (N, n), one per fleet node."""
    dev = generator.device
    lead = 1 if streams is None else streams
    n_segments = (n + dwell - 1) // dwell
    seg = torch.randint(0, n_classes, (lead, n_segments), generator=generator,
                        device=dev)
    labels = seg.repeat_interleave(dwell, dim=1)[:, :n]
    windows = har_windows(generator, labels.reshape(-1), t, channels,
                          n_classes).reshape(lead, n, t, channels)
    if streams is None:
        return windows[0], labels[0]
    return windows, labels


def class_signatures(t: int = 60, channels: int = 3, n_classes: int = 12,
                     device=None) -> torch.Tensor:
    """Noise-free per-class ground-truth traces — the memoization bank the
    sensor stores.  (L, T, C), from a fixed seed."""
    g = torch.Generator(device=device or "cpu").manual_seed(7)
    return har_windows(g, torch.arange(n_classes), t, channels, n_classes,
                       noise=0.0)
