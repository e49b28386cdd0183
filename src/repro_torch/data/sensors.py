"""Synthetic sensor data, drawn with ``torch.Generator``.

PyTorch counterpart of :mod:`repro.data.sensors`, with the same signal
families:

* HAR (MHEALTH-like): a shared quasi-periodic gait component plus three
  weak class-coded transient events per window, instance jitter and sensor
  noise;
* bearing fault (CWRU-like): the rotation fundamental and its harmonic,
  plus a fault-type impulse train at the CWRU defect multipliers, scaled by
  severity, with a ring-down and noise.

Windows are generated batched on the generator's device, so a fleet's
streams are made in bulk.  The numbers match the JAX generators in
distribution, not value for value; parity tests feed both packages the
same arrays.
"""
from __future__ import annotations

import math

import torch

__all__ = ["har_window", "har_windows", "har_stream", "har_dataset",
           "class_signatures", "bearing_window", "bearing_windows",
           "bearing_stream", "bearing_dataset"]

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
    lead = 1 if streams is None else streams
    labels = _segment_labels(generator, lead, n, n_classes, dwell)
    windows = har_windows(generator, labels.reshape(-1), t, channels,
                          n_classes).reshape(lead, n, t, channels)
    if streams is None:
        return windows[0], labels[0]
    return windows, labels


def har_dataset(generator: torch.Generator, n: int, t: int = 60,
                channels: int = 3, n_classes: int = 12):
    """IID windows for classifier training: (windows (n, T, C), labels
    (n,))."""
    labels = torch.randint(0, n_classes, (n,), generator=generator,
                           device=generator.device)
    return har_windows(generator, labels, t, channels, n_classes), labels


def _segment_labels(generator: torch.Generator, lead: int, n: int,
                    n_classes: int, dwell: int) -> torch.Tensor:
    """(lead, n) labels that change only every ``dwell`` windows."""
    n_segments = (n + dwell - 1) // dwell
    seg = torch.randint(0, n_classes, (lead, n_segments), generator=generator,
                        device=generator.device)
    return seg.repeat_interleave(dwell, dim=1)[:, :n]


def class_signatures(t: int = 60, channels: int = 3, n_classes: int = 12,
                     device=None) -> torch.Tensor:
    """Noise-free per-class ground-truth traces — the memoization bank the
    sensor stores.  (L, T, C), from a fixed seed."""
    g = torch.Generator(device=device or "cpu").manual_seed(7)
    return har_windows(g, torch.arange(n_classes), t, channels, n_classes,
                       noise=0.0)


# ---------------------------------------------------------------------------
# Bearing fault (CWRU-like)
# ---------------------------------------------------------------------------

# per class: the defect frequency as a multiple of the shaft rate (the CWRU
# BPFI/BPFO/BSF multipliers) and the severity; class 0 is healthy
_FAULT_FREQ = (0.0, 3.585, 5.415, 4.7135, 3.585, 5.415, 4.7135, 3.585, 5.415,
               4.7135)
_FAULT_SEV = (0.0, 0.6, 0.6, 0.6, 1.2, 1.2, 1.2, 2.0, 2.0, 2.0)


def bearing_windows(generator: torch.Generator, labels: torch.Tensor,
                    t: int = 120, rpm_hz: float = 15.0, fs: float = 1200.0,
                    noise: float = 0.15) -> torch.Tensor:
    """(B, T, 1) vibration windows, one of each class in ``labels`` (B,):
    class 0 healthy, 1-9 fault type x severity."""
    dev = generator.device
    labels = labels.to(dev).long()
    b = labels.shape[0]
    tgrid = torch.arange(t, device=dev, dtype=torch.float32)[None] / fs
    phase = 2 * math.pi * torch.rand((b, 1), generator=generator, device=dev)
    base = (torch.sin(2 * math.pi * rpm_hz * tgrid + phase)
            + 0.3 * torch.sin(2 * math.pi * 2 * rpm_hz * tgrid + 1.7 * phase))
    f_def = torch.tensor(_FAULT_FREQ, device=dev)[labels][:, None] * rpm_hz
    sev = torch.tensor(_FAULT_SEV, device=dev)[labels][:, None]
    jitter = 1.0 + 0.05 * torch.randn((b, 1), generator=generator, device=dev)
    impulses = sev * torch.cos(math.pi * f_def * jitter * tgrid + phase) ** 4
    ring = sev * 0.4 * torch.sin(2 * math.pi * 5.1 * rpm_hz * tgrid) * impulses
    sig = base + impulses + ring + noise * torch.randn(
        (b, t), generator=generator, device=dev)
    return sig[..., None]


def bearing_window(generator: torch.Generator, label: int, t: int = 120,
                   rpm_hz: float = 15.0, fs: float = 1200.0,
                   noise: float = 0.15) -> torch.Tensor:
    """One (T, 1) vibration window of the given class."""
    labels = torch.tensor([label], device=generator.device)
    return bearing_windows(generator, labels, t, rpm_hz, fs, noise)[0]


def bearing_stream(generator: torch.Generator, n: int, t: int = 120,
                   n_classes: int = 10, dwell: int = 16,
                   streams: int | None = None):
    """A stream of ``n`` vibration windows whose class changes only every
    ``dwell`` windows: (windows (n, T, 1), labels (n,)); with ``streams=N``,
    (N, n, T, 1) and (N, n)."""
    lead = 1 if streams is None else streams
    labels = _segment_labels(generator, lead, n, n_classes, dwell)
    windows = bearing_windows(generator, labels.reshape(-1), t
                              ).reshape(lead, n, t, 1)
    if streams is None:
        return windows[0], labels[0]
    return windows, labels


def bearing_dataset(generator: torch.Generator, n: int, t: int = 120,
                    n_classes: int = 10):
    """IID vibration windows: (windows (n, T, 1), labels (n,))."""
    labels = torch.randint(0, n_classes, (n,), generator=generator,
                           device=generator.device)
    return bearing_windows(generator, labels, t), labels
