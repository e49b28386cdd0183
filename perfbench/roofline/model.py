"""Operations and bytes of the program's kernels and model FLOPs, counted
from the shapes of the calls the timed path makes, and the H100's peaks.

The kernel counts are those ``chip_smoke.py`` holds each hand kernel to
(each input byte read once, each output byte written once); the model
FLOPs count the multiply-adds of the convolutions and dense layers as two
operations each.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # float32 outside the tensor cores (TF32 off)


def bound_s(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """The least time the chip could take, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def signature_corr(b: int, l: int, t: int, c: int):
    """(B, T, C) windows against (L, T, C) signatures -> (B, L)."""
    return 4 * (b * t * c + l * t * c + b * l), 2 * b * l * t * c + 6 * b * t * c


def kmeans_coreset(nb: int, n: int, d: int, k: int, iters: int):
    """``nb`` clouds of ``n`` points in ``d`` dimensions, ``k`` centres."""
    flops = ((iters + 1) * nb * n * k * 3 * d + iters * nb * n * d
             + iters * nb * k * d + nb * n)
    return 4 * (nb * n * d + nb * k * d + 2 * nb * k), flops


def fake_quant(numel: int):
    """abs, max, divide, round, two clamps and a multiply an element."""
    return 2 * 4 * numel, 7 * numel


KERNELS = {"signature_corr": signature_corr, "kmeans_coreset": kmeans_coreset,
           "fake_quant": fake_quant}


def cnn_flops(cfg: dict) -> float:
    """FLOPs of one window through the HAR CNN (conv-pool twice, dense,
    head)."""
    t, c, k = cfg["window"], cfg["channels"], cfg["kernel"]
    c1, c2, h, l = cfg["conv1"], cfg["conv2"], cfg["hidden"], cfg["n_classes"]
    return 2 * (t * c * c1 * k + (t // 2) * c1 * c2 * k
                + (t // 4) * c2 * h + h * l)


def generator_flops(cfg: dict) -> float:
    """FLOPs of one window through the host's recovery generator MLP."""
    d_in = cfg["latent"] + 2 * cfg["channels"]
    h = cfg["gen_hidden"]
    return 2 * (d_in * h + h * h + h * cfg["window"] * cfg["channels"])
