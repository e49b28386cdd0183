"""Coreset codecs for distributed collectives — Seeker's C1–C3 applied to a
training fleet's links.

PyTorch counterpart of :mod:`repro.core.compression`.  The two dominant
payloads are the data-parallel gradient reduction (training) and the
edge-tier → host-tier activation transfer (disaggregated serving).  Two
codecs, images of the paper's two constructions:

* :func:`topk_compress` — *importance sampling*: keep the k largest-
  magnitude entries, ship ``(value, index)`` pairs, and carry what was
  dropped in an **error-feedback** residual.  Ties in magnitude go to the
  lowest index first, as ``jax.lax.top_k`` orders them (a stable
  descending sort: ``torch.topk`` orders ties otherwise, and zero gradient
  entries tie all the time).
* :func:`kmeans1d` — *clustering*: a 1-D k-means codebook over tensor
  values; the wire format is the paper's ``(center, radius, count)``
  triple per cluster plus a 4-bit code per element.  Recovery can
  re-dither uniformly within each cluster radius (the 2r-approximation of
  §3.2.2), from a ``u`` tensor or a ``generator``.

:func:`coreset_allreduce` runs over a process group: compress locally,
all-gather the compact payload (bf16 values, int32 indices or int16
offsets as bytes), decompress and sum rank by rank in rank order.  With no
group, or a group of one, no collective runs.  The wire-byte formulas
(:func:`wire_bytes_dense_psum` against :func:`wire_bytes_topk_allgather`)
are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..sharding import all_gather_tiles, all_reduce_sum, group_shard
from ..tree import leaves, unflatten_like

__all__ = [
    "CompressionConfig", "topk_compress", "topk_decompress",
    "topk_block_compress", "topk_block_decompress", "kmeans1d",
    "kmeans1d_decompress", "Kmeans1dCoreset", "coreset_allreduce",
    "compress_activation", "decompress_activation",
    "wire_bytes_dense_psum", "wire_bytes_topk_allgather",
    "wire_bytes_kmeans1d",
]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    method: str = "topk"              # "topk" | "topk_block" | "none"
    topk_ratio: float = 1.0 / 64.0    # fraction of entries kept
    block: int = 32768                # topk_block span (int16 offsets)
    kmeans_k: int = 16                # codebook size (4-bit codes)
    kmeans_iters: int = 4             # paper's fixed Lloyd budget
    error_feedback: bool = True
    min_size: int = 2048              # leaves smaller than this go uncompressed


# ---------------------------------------------------------------------------
# Importance-sampling codec (top-k by magnitude + error feedback)
# ---------------------------------------------------------------------------

def _top_by_magnitude(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest |x| along the last dim, largest first
    and ties lowest index first (``jax.lax.top_k``'s order)."""
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True)[1]
    return order[..., :k]


def topk_compress(flat: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest-|.| entries of a 1-D
    tensor."""
    idx = _top_by_magnitude(flat, k)
    return flat[idx], idx.int()


def topk_decompress(values: torch.Tensor, indices: torch.Tensor,
                    n: int) -> torch.Tensor:
    return torch.zeros((n,), dtype=values.dtype,
                       device=values.device).index_add_(0, indices.long(),
                                                        values)


def topk_block_compress(flat: torch.Tensor, ratio: float, block: int = 32768
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-local top-k: keep the k_b largest-|.| entries of every
    ``block``-span and address them by int16 *offsets* (the block is
    implicit in the row).  Wire cost per kept entry drops from 6 B (bf16
    value + int32 index) to 4 B.

    Returns (values (n_blocks, k_b), offsets (n_blocks, k_b) int16).  The
    caller zero-pads the tensor to a block multiple."""
    n = flat.numel()
    if n % block:
        raise ValueError(f"{n} entries are no multiple of block {block}")
    k_b = max(1, int(block * ratio))
    x = flat.reshape(n // block, block)
    off = _top_by_magnitude(x, k_b)
    return torch.gather(x, 1, off), off.to(torch.int16)


def topk_block_decompress(values: torch.Tensor, offsets: torch.Tensor,
                          n: int) -> torch.Tensor:
    nb = values.shape[0]
    out = torch.zeros((nb, n // nb), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(1, offsets.long(), values).reshape(n)


# ---------------------------------------------------------------------------
# Clustering codec (1-D k-means codebook = the paper's center/radius/count)
# ---------------------------------------------------------------------------

class Kmeans1dCoreset(NamedTuple):
    centers: torch.Tensor   # (k,)
    radii: torch.Tensor     # (k,)  max |x - center| per cluster
    counts: torch.Tensor    # (k,)  int32
    codes: torch.Tensor     # (N,)  int32 in [0, k) — 4 bits on the wire for k<=16


def _linspace(lo: torch.Tensor, hi: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, k)`` in ``lo``'s dtype, on the device: ``lo *
    (1 - t) + hi * t`` at ``t = i / (k - 1)``, the last point ``hi``."""
    if k == 1:
        return lo.reshape(1)
    t = torch.arange(k - 1, dtype=lo.dtype, device=lo.device) / (k - 1)
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def _assign(centers: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    mids = 0.5 * (centers[1:] + centers[:-1])
    return torch.searchsorted(mids, flat, right=False)


def kmeans1d(flat: torch.Tensor, k: int = 16, iters: int = 4
             ) -> Kmeans1dCoreset:
    """Fixed-budget 1-D Lloyd (sorted-centroid bucketing via
    searchsorted), the centers sorted after each step."""
    centers = _linspace(flat.min(), flat.max(), k)
    for _ in range(iters):
        onehot = F.one_hot(_assign(centers, flat), k).to(flat.dtype)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ flat
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          centers)
        centers = torch.sort(new)[0]
    codes = _assign(centers, flat)
    onehot = F.one_hot(codes, k).to(flat.dtype)
    err = torch.abs(flat - centers[codes])
    return Kmeans1dCoreset(centers=centers,
                           radii=(onehot * err[:, None]).amax(dim=0),
                           counts=onehot.sum(dim=0).int(), codes=codes.int())


def kmeans1d_decompress(cs: Kmeans1dCoreset, u: torch.Tensor | None = None,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """codes -> values; with a dither ``u`` in [-1, 1) of the codes' shape,
    or one drawn uniformly from ``generator``, each value moves by ``u``
    times its cluster's radius (the paper's uniform-redistribution
    recovery)."""
    codes = cs.codes.long()
    vals = cs.centers[codes]
    if u is None and generator is not None:
        u = torch.rand(codes.shape, generator=generator,
                       device=generator.device) * 2.0 - 1.0
    if u is not None:
        vals = vals + u.to(vals.device) * cs.radii[codes]
    return vals


# ---------------------------------------------------------------------------
# Compressed all-reduce over a process group
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, shard) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (``x`` itself
    for one rank); bf16 travels as its bits."""
    if shard is None:
        return x
    if x.dtype == torch.bfloat16:
        return all_gather_tiles(x.view(torch.int16), shard).view(
            torch.bfloat16)
    return all_gather_tiles(x, shard)


def _pmean(x: torch.Tensor, shard) -> torch.Tensor:
    if shard is None:
        return x
    return all_reduce_sum(x, shard) / shard.quantum


def _leaf_allreduce_topk(g, e, shard, cfg: CompressionConfig):
    flat = g.reshape(-1).float()
    if e is not None:
        flat = flat + e.reshape(-1)
    n = flat.numel()
    k = max(1, int(n * cfg.topk_ratio))
    vals, idx = topk_compress(flat, k)
    wire_vals = vals.bfloat16()
    ndev = 1 if shard is None else shard.quantum
    gv = _gather(wire_vals, shard).reshape(ndev, k).float()
    gi = _gather(idx, shard).reshape(ndev, k).long()
    dense = torch.zeros((n,), dtype=torch.float32, device=flat.device)
    for r in range(ndev):          # rank order: the reference's scatter order
        dense.index_add_(0, gi[r], gv[r])
    mean = dense / ndev
    residual = flat - topk_decompress(wire_vals.float(), idx, n)
    return mean.reshape(g.shape).to(g.dtype), residual.reshape(g.shape)


def _leaf_allreduce_block(g, e, shard, cfg: CompressionConfig):
    """Block-local top-k variant: int16 offsets on the wire (4 B/entry)."""
    flat = g.reshape(-1).float()
    if e is not None:
        flat = flat + e.reshape(-1)
    n = flat.numel()
    block = min(cfg.block, n)
    fp = F.pad(flat, (0, (-n) % block))
    vals, off = topk_block_compress(fp, cfg.topk_ratio, block)
    wire_vals = vals.bfloat16()
    nb, k_b = vals.shape
    ndev = 1 if shard is None else shard.quantum
    gv = _gather(wire_vals, shard).reshape(ndev, nb, k_b).float()
    go = _gather(off, shard).reshape(ndev, nb, k_b)
    # the gathered rows cycle through the nb local blocks of each rank
    base = (torch.arange(nb, device=flat.device) * block)[:, None]
    dense = torch.zeros((fp.numel(),), dtype=torch.float32,
                        device=flat.device)
    for r in range(ndev):
        dense.index_add_(0, (base + go[r].long()).reshape(-1),
                         gv[r].reshape(-1))
    mean = dense[:n] / ndev
    local = topk_block_decompress(wire_vals.float(), off, fp.numel())
    residual = flat - local[:n]
    return mean.reshape(g.shape).to(g.dtype), residual.reshape(g.shape)


def coreset_allreduce(grads, group, cfg: CompressionConfig, ef_state=None):
    """Compressed mean-all-reduce of a gradient tree over a process group.

    Args:
        grads: this rank's gradient tree.
        group: the ``torch.distributed`` process group to reduce over (the
            default group is ``torch.distributed.group.WORLD``), or None
            for one rank; a group of one runs no collective either.
        cfg: codec config.
        ef_state: tree like grads with the error-feedback residuals (None
            disables them; on step 0 pass zeros).

    Returns (mean_grads, new_ef_state).  Leaves under ``cfg.min_size``
    entries (or every leaf with ``method="none"``) take a plain mean
    all-reduce and a zero residual.
    """
    shard = None
    if group is not None:
        shard = group_shard(group)
        if shard.quantum == 1:
            shard = None
    g_leaves = leaves(grads)
    e_leaves = (leaves(ef_state) if ef_state is not None
                else [None] * len(g_leaves))
    out, new_ef = [], []
    for g, e in zip(g_leaves, e_leaves):
        if cfg.method == "none" or g.numel() < cfg.min_size:
            out.append(_pmean(g, shard))
            new_ef.append(torch.zeros_like(g))
            continue
        fn = (_leaf_allreduce_block if cfg.method == "topk_block"
              else _leaf_allreduce_topk)
        m, r = fn(g, e if cfg.error_feedback else None, shard, cfg)
        out.append(m)
        new_ef.append(r.to(g.dtype))
    return unflatten_like(grads, out), unflatten_like(grads, new_ef)


# ---------------------------------------------------------------------------
# Activation codec for the edge->host offload (D3 path, distributed)
# ---------------------------------------------------------------------------

def compress_activation(x: torch.Tensor,
                        cfg: CompressionConfig) -> Kmeans1dCoreset:
    """Clustering-coreset compression of an activation tensor (any
    shape)."""
    return kmeans1d(x.reshape(-1).float(), cfg.kmeans_k, cfg.kmeans_iters)


def decompress_activation(cs: Kmeans1dCoreset, shape,
                          dtype: torch.dtype = torch.float32,
                          u: torch.Tensor | None = None,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    return kmeans1d_decompress(cs, u, generator).reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# Wire-byte accounting (feeds the roofline collective term)
# ---------------------------------------------------------------------------

def wire_bytes_dense_psum(n_elems: int, ndev: int,
                          bytes_per_elem: int = 2) -> float:
    """Ring all-reduce moves ~2·(N/ndev)·(ndev-1) ≈ 2N bytes per device."""
    return 2.0 * n_elems * bytes_per_elem * (ndev - 1) / ndev


def wire_bytes_topk_allgather(n_elems: int, ndev: int, ratio: float,
                              bytes_val: int = 2, bytes_idx: int = 4) -> float:
    """All-gather of compressed payloads: each device receives
    (ndev-1)·k·(val+idx) bytes."""
    k = max(1, int(n_elems * ratio))
    return (ndev - 1) * k * (bytes_val + bytes_idx)


def wire_bytes_kmeans1d(n_elems: int, k: int = 16, bits_code: int = 4,
                        bytes_center: int = 2, bytes_radius: int = 1,
                        bits_count: int = 4) -> float:
    """Point-to-point transfer of a clustering-coreset payload."""
    return (n_elems * bits_code / 8.0
            + k * (bytes_center + bytes_radius)
            + k * bits_count / 8.0)
