"""Recoverable coreset reconstruction (paper §3.2.2 + appendix A.1).

PyTorch counterpart of :mod:`repro.core.recovery`.  Both recoveries take
their random draws as tensors instead of a PRNG key, so a test can hand
them the numbers JAX drew:

* :func:`recover_cluster_window` takes, per channel, ``(T, 2)`` normal
  directions and ``(T, 1)`` uniform radii (``repro/core/recovery.py:56-59``,
  keyed per channel through ``recovery.py:96``);
* :func:`recover_sampling_window` takes the ``(16,)`` normal latent
  (``recovery.py:167``).

Every function also takes a leading batch of nodes.  The discriminator
(:func:`init_discriminator`, :func:`discriminator_apply`) is the critic
that trains the generator; no serving path calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .coreset import ClusterCoreset, SamplingCoreset, window_from_points

__all__ = ["recover_cluster_points", "recover_cluster_window",
           "GeneratorParams", "init_generator", "generator_apply",
           "recover_sampling_window", "DiscriminatorParams",
           "init_discriminator", "discriminator_apply"]


def _uniform_in_ball(dirs: torch.Tensor,
                     radii_u: torch.Tensor) -> torch.Tensor:
    """Points in the unit ball with radius ~ U[0, 1] (the norm trick):
    ``dirs`` (..., n, d) normals, ``radii_u`` (..., n, 1) uniforms."""
    norm = torch.sqrt((dirs * dirs).sum(dim=-1, keepdim=True))
    return dirs / torch.clamp(norm, min=1e-9) * radii_u


def recover_cluster_points(cs: ClusterCoreset, dirs: torch.Tensor,
                           radii_u: torch.Tensor, n_points: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-synthesize ``n_points`` candidate points from a clustering coreset
    (centers (..., k, d)), spread over the clusters in proportion to their
    counts and uniformly inside each cluster's ball.  Returns the points
    (..., n_points, d) and the validity mask (first ``sum(counts)``)."""
    k = cs.centers.shape[-2]
    counts = cs.counts.to(torch.int64)
    total = torch.clamp(counts.sum(dim=-1, keepdim=True), min=1)
    cum = torch.cumsum(counts, dim=-1)
    slots = torch.arange(n_points, device=counts.device)
    slot_pos = (slots * total) // n_points                    # (..., n)
    slot_cluster = torch.clamp(
        torch.searchsorted(cum.contiguous(), slot_pos.contiguous(),
                           right=True), 0, k - 1)
    mask = slots < total
    offs = _uniform_in_ball(dirs, radii_u)
    centers = cs.centers.gather(
        -2, slot_cluster[..., None].expand(slot_cluster.shape
                                           + cs.centers.shape[-1:]))
    radii = cs.radii.gather(-1, slot_cluster)
    return centers + offs * radii[..., None], mask


def recover_cluster_window(cs: ClusterCoreset, dirs: torch.Tensor,
                           radii_u: torch.Tensor, t: int) -> torch.Tensor:
    """Coreset -> synthesized points -> regular (T, C) window.

    A joint coreset (centers (k, D)) takes ``dirs`` (T, D) and ``radii_u``
    (T, 1).  The per-channel layout of :func:`channel_cluster_coresets`
    (centers (..., C, k, 2)) takes ``dirs`` (..., C, T, 2) and ``radii_u``
    (..., C, T, 1) and returns (..., T, C)."""
    if cs.centers.ndim >= 3:
        pts, _ = recover_cluster_points(cs, dirs, radii_u, n_points=t)
        cols = window_from_points(pts, t)[..., 0]           # (..., C, T)
        return cols.transpose(-1, -2)
    pts, _ = recover_cluster_points(cs, dirs, radii_u, n_points=t)
    return window_from_points(pts, t)


class GeneratorParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


def _mlp3(generator: torch.Generator, in_dim: int, hidden: int,
          out_dim: int) -> tuple[torch.Tensor, ...]:
    """Three dense layers, normal / sqrt(fan_in) weights and zero biases,
    on the torch generator's device."""
    dev = generator.device

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev)
                / fan_in ** 0.5)

    return (normal((in_dim, hidden), in_dim),
            torch.zeros((hidden,), device=dev),
            normal((hidden, hidden), hidden),
            torch.zeros((hidden,), device=dev),
            normal((hidden, out_dim), hidden),
            torch.zeros((out_dim,), device=dev))


def init_generator(generator: torch.Generator, t: int, channels: int,
                   latent: int = 16, hidden: int = 128,
                   n_classes: int = 0) -> GeneratorParams:
    """Generator g(noise, mean, std[, class]) -> (T, C) window, on the
    torch generator's device."""
    return GeneratorParams(*_mlp3(generator, latent + 2 * channels
                                  + n_classes, hidden, t * channels))


def generator_apply(params: GeneratorParams, noise: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor,
                    class_onehot: torch.Tensor | None = None,
                    t: int | None = None) -> torch.Tensor:
    """Synthesize (..., T, C) windows from the coreset's conditioning."""
    cond = [noise, mean, torch.sqrt(torch.clamp(var, min=0.0))]
    if class_onehot is not None:
        cond.append(class_onehot)
    h = torch.cat(cond, dim=-1)
    h = torch.tanh(h @ params.w1 + params.b1)
    h = torch.tanh(h @ params.w2 + params.b2)
    out = h @ params.w3 + params.b3
    channels = mean.shape[-1]
    t = t if t is not None else out.shape[-1] // channels
    return out.reshape(out.shape[:-1] + (t, channels))


def recover_sampling_window(params: GeneratorParams, cs: SamplingCoreset,
                            latent: torch.Tensor, t: int,
                            class_onehot: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The generator fills in the dropped samples; the transmitted points
    are written back verbatim at their indices.  ``latent`` (..., 16) is
    the normal draw of ``repro/core/recovery.py:167``."""
    synth = generator_apply(params, latent, cs.mean, cs.var, class_onehot,
                            t=t)
    idx = cs.indices.to(torch.int64)[..., None].expand(cs.values.shape)
    return synth.scatter(-2, idx, cs.values)


# ---------------------------------------------------------------------------
# Discriminator (training-time only)
# ---------------------------------------------------------------------------

class DiscriminatorParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


def init_discriminator(generator: torch.Generator, t: int, channels: int,
                       hidden: int = 128) -> DiscriminatorParams:
    """Critic d((T, C) window) -> realness score, on the torch generator's
    device."""
    return DiscriminatorParams(*_mlp3(generator, t * channels, hidden, 1))


def discriminator_apply(params: DiscriminatorParams,
                        window: torch.Tensor) -> torch.Tensor:
    """(..., T, C) windows -> (...) scores: three dense layers with
    leaky-ReLU (slope 0.2) between them."""
    h = window.reshape(window.shape[:-2] + (-1,))
    h = F.leaky_relu(h @ params.w1 + params.b1, 0.2)
    h = F.leaky_relu(h @ params.w2 + params.b2, 0.2)
    return (h @ params.w3 + params.b3)[..., 0]
