"""Plain reference of the host tier's serve slot: the edge's wire frame of
each window, the frame's signature, the recovery noise keyed by it, the
cluster recovery and the host CNN, and the deadline-ordered queue's QoS
counts.  Imports nothing of the program; the sensor's blocks come from
:mod:`perfbench.reference.seeker`.

The wire frame: per-channel k-means coresets quantized to int16 centre
codes over the window's centre range, int8 radius codes over its largest
radius, and counts clipped to 4 bits.  A queue entry is that frame beside
an all-zero sampling half (``kind`` 0, ``task`` 0), and its signature two
32-bit multiply-xorshift mixes of the entry's words in field order.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import seeker as ref

MASK32 = ref.MASK32
MIX_SEEDS = (2654435761, 2246822519)


def wire_frame(win: torch.Tensor, k: int, iters: int, tf32: bool = False):
    """(B, T, C) windows -> the frame's fields: c_codes (B, C, k, 2) int16,
    r_codes and n_codes (B, C, k) int8, lo, hi, rhi (B,) float32."""
    b, t, c = win.shape
    centers, radii, counts = ref.kmeans(ref.channel_points(win), k, iters,
                                        tf32)
    centers = centers.reshape(b, c, k, 2)
    radii, counts = radii.reshape(b, c, k), counts.reshape(b, c, k)
    lo = centers.amin(dim=(1, 2, 3), keepdim=True)
    hi = centers.amax(dim=(1, 2, 3), keepdim=True)
    c_codes = torch.round((centers - lo) / torch.clamp(hi - lo, min=1e-9)
                          * 65535.0 - 32768.0).to(torch.int16)
    rhi = radii.amax(dim=(1, 2), keepdim=True)
    r_codes = torch.round(radii / torch.clamp(rhi, min=1e-9) * 255.0
                          - 128.0).to(torch.int8)
    n_codes = torch.clamp(counts, 0, 15).to(torch.int8)
    return {"c_codes": c_codes, "r_codes": r_codes, "n_codes": n_codes,
            "lo": lo.reshape(b), "hi": hi.reshape(b), "rhi": rhi.reshape(b)}


def _words(x: torch.Tensor, b: int) -> torch.Tensor:
    if x.is_floating_point():
        x = x.to(torch.float32).contiguous().view(torch.int32)
    return x.reshape(b, -1).to(torch.int32)


def signatures(frame: dict, m: int) -> torch.Tensor:
    """(B, 2) signatures of the queue entries that carry ``frame``."""
    b, c = frame["c_codes"].shape[:2]
    dev = frame["lo"].device

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((b,) + shape, dtype=dtype, device=dev)

    leaves = [zeros(dtype=torch.int8), frame["c_codes"], frame["r_codes"],
              frame["n_codes"], frame["lo"], frame["hi"], frame["rhi"],
              zeros(m, dtype=torch.int8), zeros(m, c, dtype=torch.int16),
              zeros(), zeros(), zeros(c), zeros(c), zeros(dtype=torch.int8)]
    words = torch.cat([_words(x, b) for x in leaves], dim=1).to(
        torch.int64) & MASK32
    idx = torch.arange(words.shape[1], dtype=torch.int64, device=dev)
    mult = []
    for seed in MIX_SEEDS:
        v = (ref.mul32(idx, 2654435761) + seed) & MASK32
        v = ref.mul32(v ^ (v >> 15), 2246822519)
        mult.append((v ^ (v >> 13)) | 1)
    h = ref.mul32((words ^ (words >> 16))[:, None, :],
                  torch.stack(mult)).sum(dim=-1) & MASK32
    h = ref.mul32(h ^ (h >> 15), 2246822519)
    return h ^ (h >> 13)


def recovery_noise(sigs: torch.Tensor, seed: int, c: int, t: int) -> dict:
    """Ball directions (B, C, T, 2) and radii (B, C, T, 1) keyed by each
    entry's signature and the server's seed."""
    b = sigs.shape[0]
    n_dir, n_rad = c * t * 2, c * t
    n_norm = n_dir + ref.LATENT
    key = ref.fmix32(ref.fmix32(sigs[:, 0] ^ ((seed & MASK32) ^ ref.HOST_SALT))
                     ^ sigs[:, 1])
    u = ref.word_uniforms(ref.counter_words(key, 2 * n_norm + n_rad))
    z = ref.box_muller(u[:, :n_norm], u[:, n_norm:2 * n_norm])
    return {"dirs": z[:, :n_dir].reshape(b, c, t, 2),
            "radii_u": (1.0 - u[:, 2 * n_norm:]).reshape(b, c, t, 1)}


def serve_logits(frame: dict, sigs: torch.Tensor, weights: dict, seed: int,
                 t: int, tf32: bool = False) -> torch.Tensor:
    """The host's logits of each frame: dequantize, recover the window with
    the noise its signature keys, run the host CNN."""
    b, c = frame["c_codes"].shape[:2]
    lo, hi = frame["lo"].reshape(b, 1, 1, 1), frame["hi"].reshape(b, 1, 1, 1)
    centers = ((frame["c_codes"].to(torch.float32) + 32768.0) / 65535.0
               * (hi - lo) + lo)
    radii = ((frame["r_codes"].to(torch.float32) + 128.0) / 255.0
             * frame["rhi"].reshape(b, 1, 1))
    noise = recovery_noise(sigs, seed, c, t)
    win = ref.recover_cluster(centers, radii, frame["n_codes"].to(torch.int32),
                              noise["dirs"], noise["radii_u"], t)
    return ref.cnn(weights, win, tf32)


def edf_slots(alive: np.ndarray, capacity: int, batch: int, batches: int,
              qos: int):
    """QoS of a server fed one frame from each alive node a slot.  Each
    slot: the slot's frames join the queue with deadline ``slot + qos``
    (frames beyond the free capacity are dropped: every resident's
    deadline is earlier, so none is evicted); then ``batches`` times,
    entries past their deadline expire as misses and up to ``batch`` of
    the earliest deadlines, first come first served among equals, are
    served.  Returns the served node ids of each slot and the totals."""
    queue: list[tuple[int, int, int]] = []        # (deadline, order, node)
    served, misses, drops, order = [], 0, 0, 0
    for now, row in enumerate(alive):
        free = capacity - len(queue)
        arrivals = np.nonzero(row)[0]
        drops += max(0, len(arrivals) - free)
        for node in arrivals[:max(free, 0)]:
            queue.append((now + qos, order, int(node)))
            order += 1
        # every batch of a slot sees the same clock: what expires, expires
        # before the first, and the batches take the earliest deadlines
        live = sorted(e for e in queue if e[0] >= now)
        misses += len(queue) - len(live)
        out = [e[2] for e in live[:batch * batches]]
        queue = live[batch * batches:]
        served.append(out)
    return served, {"served": sum(map(len, served)), "misses": misses,
                    "drops": drops}
