"""Learning-rate schedules: float32 functions of a step tensor.

PyTorch counterpart of :mod:`repro.optim.schedule`, in the same float32
operations.
"""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant_lr"]


def warmup_cosine(step: torch.Tensor, peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``."""
    s = step.float()
    warm = peak * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)


def constant_lr(step: torch.Tensor, peak: float, **_) -> torch.Tensor:
    return torch.full_like(step, peak, dtype=torch.float32)
