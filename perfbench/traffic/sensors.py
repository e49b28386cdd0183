"""Seeded inputs of the Seeker cells: sensor windows, harvest traces,
signature banks and model weights, all drawn on the device from one
``torch.Generator``.

Frozen copies of the port's generators (``data/sensors.py``
``har_windows``, ``bearing_windows``, ``class_signatures``,
``_segment_labels``; ``core/energy.py`` ``fleet_harvest_traces``,
``fleet_alive_traces``; ``models/har.py`` ``har_init``;
``core/recovery.py`` ``init_generator``),
kept here so that a change to the program cannot move the yardstick.  The
program receives only what these functions make.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_N_HARM = 14
SLOT_SECONDS = 0.6
EH_SOURCES = ("rf", "wifi", "piezo", "solar")
_FAULT_FREQ = (0.0, 3.585, 5.415, 4.7135, 3.585, 5.415, 4.7135, 3.585, 5.415,
               4.7135)
_FAULT_SEV = (0.0, 0.6, 0.6, 0.6, 1.2, 1.2, 1.2, 2.0, 2.0, 2.0)


def _class_params(n_classes: int, channels: int, t: int, device):
    g = torch.Generator().manual_seed(1234)
    lo, hi = int(0.10 * t), int(0.90 * t)
    pos = torch.round(lo + (hi - lo) * torch.rand((n_classes, 3), generator=g))
    width = 0.8 + 1.2 * torch.rand((n_classes, 3), generator=g)
    amp = 0.45 + 0.25 * torch.rand((n_classes, 3, channels), generator=g)
    sign = torch.sign(torch.randn((n_classes, 3, channels), generator=g))
    return pos.to(device), width.to(device), (amp * sign).to(device)


def har_windows(generator: torch.Generator, labels: torch.Tensor, t: int,
                channels: int, n_classes: int, fs: float = 50.0,
                noise: float = 0.12) -> torch.Tensor:
    """(B, T, C) MHEALTH-like windows: a shared quasi-periodic gait
    component plus three weak class-coded transient events and noise."""
    dev = generator.device
    labels = labels.to(dev).long()
    b = labels.shape[0]
    pos, width, amp = _class_params(n_classes, channels, t, dev)
    tgrid = torch.arange(t, device=dev, dtype=torch.float32) / fs
    idx = torch.arange(t, device=dev, dtype=torch.float32)
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


def bearing_windows(generator: torch.Generator, labels: torch.Tensor,
                    t: int, rpm_hz: float = 15.0, fs: float = 1200.0,
                    noise: float = 0.15) -> torch.Tensor:
    """(B, T, 1) CWRU-like vibration windows: class 0 healthy, 1-9 fault
    type x severity."""
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


def family_windows(family: str, generator, labels, cfg: dict,
                   noise: float | None = None) -> torch.Tensor:
    """Windows of ``family`` ("har" or "bearing") at the configuration's
    (T, C); ``noise`` overrides the family's sensor noise."""
    kw = {} if noise is None else {"noise": noise}
    if family == "har":
        return har_windows(generator, labels, cfg["window"], cfg["channels"],
                           cfg["n_classes"], **kw)
    if family == "bearing":
        if cfg["channels"] != 1:
            raise ValueError("bearing windows have one channel")
        return bearing_windows(generator, labels, cfg["window"], **kw)
    raise ValueError(f"unknown window family {family!r}; "
                     f"options: ['bearing', 'har']")


def segment_labels(generator: torch.Generator, lead: int, n: int,
                   n_classes: int, dwell: int) -> torch.Tensor:
    """(lead, n) class labels that change only every ``dwell`` windows."""
    n_segments = (n + dwell - 1) // dwell
    seg = torch.randint(0, n_classes, (lead, n_segments), generator=generator,
                        device=generator.device)
    return seg.repeat_interleave(dwell, dim=1)[:, :n]


def node_streams(generator: torch.Generator, family: str, cfg: dict,
                 nodes: int, slots: int, dwell: int) -> torch.Tensor:
    """(N, S, T, C) per-node window streams whose class changes every
    ``dwell`` slots, drawn in blocks of nodes so the generator's
    temporaries stay small."""
    labels = segment_labels(generator, nodes, slots, cfg["n_classes"], dwell)
    out = torch.empty((nodes, slots, cfg["window"], cfg["channels"]),
                      device=generator.device)
    block = max(1, (1 << 18) // slots)
    for lo in range(0, nodes, block):
        hi = min(nodes, lo + block)
        out[lo:hi] = family_windows(
            family, generator, labels[lo:hi].reshape(-1), cfg).reshape(
                hi - lo, slots, cfg["window"], cfg["channels"])
    return out


def signature_bank(family: str, cfg: dict, device) -> torch.Tensor:
    """(L, T, C) noise-free per-class traces from the fixed seed 7: the
    memoization bank a sensor stores."""
    g = torch.Generator(device=device).manual_seed(7)
    return family_windows(family, g, torch.arange(cfg["n_classes"]), cfg,
                          noise=0.0)


def _bursty(gen, rows: int, n: int, mean_power_uw: float, burstiness: float,
            period: float) -> torch.Tensor:
    dev = gen.device
    t = torch.arange(n, device=dev, dtype=torch.float32) * SLOT_SECONDS
    base = 0.5 * (1.0 + torch.sin(2 * math.pi * t / period))
    z = torch.randn((rows, n), generator=gen, device=dev)
    noise = torch.exp(burstiness * z - 0.5 * burstiness ** 2)
    u = torch.rand((rows, n), generator=gen, device=dev)
    dropout = (u > 0.15).to(torch.float32)
    return mean_power_uw * base * noise * dropout * SLOT_SECONDS


def _source_traces(gen, rows: int, n: int, source: str) -> torch.Tensor:
    dev = gen.device
    if source == "rf":
        return _bursty(gen, rows, n, 45.0, 0.9, 40.0)
    if source == "wifi":
        return _bursty(gen, rows, n, 70.0, 1.2, 15.0)
    if source == "piezo":
        active = (torch.rand((rows, n), generator=gen, device=dev)
                  > 0.35).to(torch.float32)
        jitter = 1.0 + 0.3 * torch.randn((rows, n), generator=gen, device=dev)
        return torch.clamp(250.0 * active * jitter, min=0.0) * SLOT_SECONDS
    if source == "solar":
        t = torch.arange(n, device=dev, dtype=torch.float32) * SLOT_SECONDS
        diurnal = torch.clamp(torch.sin(2 * math.pi * t / (n * SLOT_SECONDS)),
                              min=0.0)
        clouds = 0.6 + 0.4 * torch.rand((rows, n), generator=gen, device=dev)
        return 800.0 * diurnal * clouds * SLOT_SECONDS
    raise ValueError(f"unknown harvest source {source!r}; "
                     f"options: {EH_SOURCES}")


def harvest_traces(generator: torch.Generator, nodes: int, slots: int,
                   sources=EH_SOURCES) -> torch.Tensor:
    """(N, S) µJ harvested a slot: node ``i`` takes source ``i % len``
    (round-robin), every node its own draws."""
    sources = tuple(sources)
    out = torch.zeros((nodes, slots), dtype=torch.float32,
                      device=generator.device)
    node_src = np.arange(nodes) % len(sources)
    for si, src in enumerate(sources):
        sel = np.nonzero(node_src == si)[0]
        if sel.size:
            idx = torch.as_tensor(sel, device=generator.device)
            out[idx] = _source_traces(generator, sel.size, slots, src)
    return out


def cnn_weights(generator: torch.Generator, cfg: dict) -> dict:
    """The HAR 1-D CNN's weights, normal / sqrt(fan_in) and zero biases, in
    the program's layouts: conv (K, Cin, Cout), dense (in, out)."""
    dev = generator.device

    def norm(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / fan_in ** 0.5

    k, c, c1, c2 = cfg["kernel"], cfg["channels"], cfg["conv1"], cfg["conv2"]
    flat = (cfg["window"] // 4) * c2
    return {
        "conv1_w": norm((k, c, c1), k * c),
        "conv1_b": torch.zeros((c1,), device=dev),
        "conv2_w": norm((k, c1, c2), k * c1),
        "conv2_b": torch.zeros((c2,), device=dev),
        "dense_w": norm((flat, cfg["hidden"]), flat),
        "dense_b": torch.zeros((cfg["hidden"],), device=dev),
        "head_w": norm((cfg["hidden"], cfg["n_classes"]), cfg["hidden"]),
        "head_b": torch.zeros((cfg["n_classes"],), device=dev),
    }


def generator_weights(generator: torch.Generator, cfg: dict) -> tuple:
    """The host's recovery generator, an MLP (latent + 2C) -> hidden ->
    hidden -> T * C: (w1, b1, w2, b2, w3, b3)."""
    dev = generator.device
    d_in = cfg["latent"] + 2 * cfg["channels"]
    h, d_out = cfg["gen_hidden"], cfg["window"] * cfg["channels"]

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev)
                / fan_in ** 0.5)

    return (normal((d_in, h), d_in), torch.zeros((h,), device=dev),
            normal((h, h), h), torch.zeros((h,), device=dev),
            normal((h, d_out), h), torch.zeros((d_out,), device=dev))


def alive_traces(generator: torch.Generator, nodes: int, slots: int,
                 duty: float, period: int, p_glitch: float) -> torch.Tensor:
    """(N, S) bool dropout and rejoin: node ``i`` is up while
    ``(t + phase_i) % period < duty * period`` and it does not glitch (an
    independent per-slot dropout of probability ``p_glitch``)."""
    dev = generator.device
    phases = torch.randint(0, period, (nodes,), generator=generator,
                           device=dev, dtype=torch.int32)
    t = torch.arange(slots, dtype=torch.int32, device=dev)
    on = (t[None, :] + phases[:, None]) % period < duty * period
    glitch = torch.rand((nodes, slots), generator=generator,
                        device=dev) < p_glitch
    return on & ~glitch
