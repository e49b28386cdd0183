"""Dispatch for the hand-written CUDA kernels.

Counterpart of :mod:`repro.kernels.ops`, with the same op names.  Each op
looks at where its tensors lie:

* on the CPU it runs the plain PyTorch version from
  :mod:`repro_torch.kernels.ref` — the CPU tests' path;
* on a CUDA device it launches its kernel (built at first use by
  :mod:`repro_torch.kernels.build`) or raises; it never falls back.

Each op counts its kernel launches (:func:`launch_counts`), so a run can
show that its main path went through the kernels.  The wrappers check
dtype, device, shape and contiguity, allocate the outputs, and launch on
PyTorch's current stream; a refused launch raises at once.

The launch geometry of every kernel (tile or group size, blocks, threads,
shared memory, instantiation) is computed here in plain Python
(:func:`signature_corr_geometry`, :func:`fake_quant_geometry`,
:func:`kmeans_coreset_geometry`, :func:`importance_select_geometry`), so
the CPU tests can check it; the CUDA side refuses a geometry that does not
fit its layout.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import ref

__all__ = ["signature_corr_op", "fake_quant_op", "kmeans_coreset_op",
           "importance_select_op", "launch_counts", "reset_launch_counts",
           "kernel_library", "Geometry", "signature_corr_geometry",
           "fake_quant_geometry", "fake_quant_constants",
           "kmeans_coreset_geometry", "importance_select_geometry", "SMS",
           "MAX_T"]

SMS = 132                      # streaming multiprocessors of an H100 SXM
SMEM_DEFAULT = 48 * 1024       # dynamic shared memory without the opt-in
SMEM_OPTIN = 232_448           # the most a block may opt in to (227 KB)
SMEM_PER_SM = 233_472          # shared memory an SM gives its blocks
# signature_corr.cu: threads per block at most
CORR_MAX_THREADS = 1024
# kmeans_coreset.cu: lanes per cloud, threads per block, and the
# (K_MAX, D_MAX, N_MAX) instantiations with their __launch_bounds__ minimum
# of resident blocks per SM
KMEANS_GROUP, KMEANS_THREADS = 8, 64
KMEANS_VARIANTS = ((16, 2, 64, 12), (32, 4, 64, 8), (32, 2, 128, 6),
                   (32, 4, 128, 4))
# the longest window (kmeans_coreset: cloud) the kernels take: the bearing
# config's 120 samples fit, and the int8 index field of the sampling wire
# format caps T at 127 anyway
MAX_T = 128
# fake_quant.cu: threads per block and the __launch_bounds__ minimum of
# resident blocks per SM (every kernel), items a thread holds in registers,
# elements per thread of a per-channel block, and the most columns whose
# maxima a per-channel block keeps in shared memory (more: variant 5)
FQ_THREADS, FQ_PER_SM, FQ_HELD = 256, 4, 8
FQ_CHANNEL_ITEMS, FQ_MAX_COLS = 8, 4096
# importance_select.cu: windows (warps) per block at most, and the time steps
# a lane owns in the two instantiations (T <= 64, T <= 128)
IMP_MAX_WARPS = 32
IMP_STEPS = (2, 4)


class Geometry(NamedTuple):
    """One launch: ``tile`` nodes (or clouds) per block, ``group`` lanes
    per cloud (0 where a thread takes an item), ``blocks``, ``threads`` per
    block, ``smem`` bytes of dynamic shared memory, whether that needs the
    opt-in above 48 KB, the instantiation ``variant`` passed to the
    launch, and ``per_sm``, the blocks an SM holds at once at least."""
    tile: int
    group: int
    blocks: int
    threads: int
    smem: int
    optin: bool
    variant: int
    per_sm: int

    @property
    def waves(self) -> int:
        """Waves of blocks on an H100's :data:`SMS` SMs."""
        return -(-self.blocks // (SMS * self.per_sm))


def _per_sm(threads: int, smem: int, min_blocks: int) -> int:
    # 2048 threads and 32 blocks an SM; 1 KB of shared memory kept per block
    return max(1, min(min_blocks, 2048 // threads, 32,
                      SMEM_PER_SM // (smem + 1024)))


def _corr_row_stride(t: int, c: int) -> int:
    # signature_corr.cu row_stride: T rounded up to 4 steps, 4 mod 8 floats
    s = -(-t // 4) * 4 * c
    return s if s % 8 == 4 else s + 4


def signature_corr_geometry(b: int, l: int, t: int, c: int) -> Geometry:
    """Tiles of ``tile`` consecutive nodes, about one block per SM for the
    fleet's nodes; the windows and the bank staged in padded rows, plus one
    norm per column.  The instantiation ``variant`` is C."""
    if not (1 <= t <= MAX_T and 1 <= c <= 4 and l >= 1
            and (l * t * c + l * c) * 4 <= 48 * 1024):
        raise ValueError(f"signature_corr: kernel takes T <= {MAX_T}, C <= 4 "
                         f"and a bank of at most 48 KB, got T={t}, C={c}, "
                         f"L={l}")
    row = _corr_row_stride(t, c) + c        # floats per staged row + norms
    most = (SMEM_OPTIN // 4 - l * row) // row
    tile = max(1, min(-(-b // SMS), most))
    threads = min(CORR_MAX_THREADS, -(-tile * l // 32) * 32)
    smem = 4 * (tile + l) * row
    return Geometry(tile=tile, group=0, blocks=-(-b // tile), threads=threads,
                    smem=smem, optin=smem > SMEM_DEFAULT, variant=c,
                    per_sm=_per_sm(threads, smem, 1))


def kmeans_coreset_geometry(b: int, n: int, d: int, k: int) -> Geometry:
    """Groups of :data:`KMEANS_GROUP` lanes, one cloud each, and the first
    (K_MAX, D_MAX, N_MAX) instantiation that holds ``k``, ``d`` and ``n``."""
    if not (1 <= n <= MAX_T and 1 <= d <= 4 and 1 <= k <= 32):
        raise ValueError(f"kmeans_coreset: kernel takes N <= {MAX_T}, D <= 4, "
                         f"k <= 32, got N={n}, D={d}, k={k}")
    variant = next(i for i, (kmax, dmax, nmax, _)
                   in enumerate(KMEANS_VARIANTS)
                   if k <= kmax and d <= dmax and n <= nmax)
    kmax, dmax, _, min_blocks = KMEANS_VARIANTS[variant]
    clouds = KMEANS_THREADS // KMEANS_GROUP
    # points, centres, radii and counts per cloud; the lanes' partial sums
    smem = 4 * (clouds * (n * d + kmax * dmax + 1 + 2 * kmax)
                + k * (d + 1) * (KMEANS_THREADS + 4))
    return Geometry(tile=clouds, group=KMEANS_GROUP, blocks=-(-b // clouds),
                    threads=KMEANS_THREADS, smem=smem,
                    optin=smem > SMEM_DEFAULT, variant=variant,
                    per_sm=_per_sm(KMEANS_THREADS, smem, min_blocks))


def fake_quant_constants(bits: int) -> tuple[float, float]:
    """``(qmax, rq)`` at ``bits``: the largest level and the float32
    reciprocal ``float32(1) / float32(qmax)`` that
    :func:`repro_torch.kernels.ref.fake_quant_scale` multiplies by."""
    qmax = 2.0 ** (bits - 1) - 1.0
    return qmax, float(np.float32(1.0) / np.float32(qmax))


def fake_quant_geometry(numel: int, cols: int, groups: int,
                        per_channel: bool, aligned: bool) -> Geometry:
    """The kernel and launch for ``numel`` floats of ``cols`` columns with a
    scale per group of ``numel // groups`` consecutive floats (per node, or
    per tensor where ``groups`` is 1) or per column (``per_channel``);
    ``aligned``: input and output start on 16 bytes.

    ``variant`` 0 and 1: one group per warp, ``tile`` groups a block,
    float4 items (0) or floats (1); 2 and 3: per tensor (float4 or
    floats), 4: per channel with the column maxima in shared memory (at
    most :data:`FQ_MAX_COLS` columns), 5: per channel with them in the
    scratch, any column count; each of 2-5 one cooperative launch of at
    most the blocks that are resident at once."""
    if not (numel >= 1 and cols >= 1 and groups >= 1 and numel % groups == 0
            and numel % cols == 0 and numel // groups < 2 ** 31
            and groups < 2 ** 31 and cols < 2 ** 31
            and (not per_channel or groups == 1)):
        raise ValueError(f"fake_quant: kernel takes whole groups of fewer "
                         f"than 2**31 floats, per channel one group, got "
                         f"numel={numel}, cols={cols}, groups={groups}, "
                         f"per_channel={per_channel}")
    if per_channel:
        blocks = min(-(-numel // (FQ_THREADS * FQ_CHANNEL_ITEMS)), SMS)
        wide = cols > FQ_MAX_COLS
        return Geometry(tile=0, group=0, blocks=blocks, threads=FQ_THREADS,
                        smem=0 if wide else 4 * cols, optin=False,
                        variant=5 if wide else 4, per_sm=FQ_PER_SM)
    size = numel // groups
    vec = aligned and size % 4 == 0
    if groups == 1:
        items = size // 4 if vec else size
        blocks = min(-(-items // (FQ_THREADS * FQ_HELD)), SMS * FQ_PER_SM)
        return Geometry(tile=0, group=0, blocks=blocks, threads=FQ_THREADS,
                        smem=0, optin=False, variant=2 if vec else 3,
                        per_sm=FQ_PER_SM)
    tile = FQ_THREADS // 32
    return Geometry(tile=tile, group=32, blocks=-(-groups // tile),
                    threads=FQ_THREADS, smem=0, optin=False,
                    variant=0 if vec else 1, per_sm=FQ_PER_SM)


def _imp_warp_bytes(t: int, c: int) -> int:
    # importance_select.cu warp_floats: the window and the T weights, each
    # rounded up to whole float4s
    return 4 * (-(-t * c // 4) * 4 + -(-t // 4) * 4)


def importance_select_geometry(b: int, t: int, c: int, m: int,
                               avg_width: int) -> Geometry:
    """One warp per window, ``tile`` windows a block: about one block per SM
    for the fleet's windows, within the default 48 KB of shared memory.
    ``variant`` 0 is the (C, width) = (3, 8) instantiation, 1 the
    runtime one, each with :data:`IMP_STEPS` ``[0]`` time steps a lane
    (T <= 64); 2 and 3 are the same with ``[1]`` (T <= 128)."""
    if not (b >= 1 and 1 <= t <= MAX_T and 1 <= c <= 8 and 1 <= m <= t
            and avg_width >= 1):
        raise ValueError(f"importance_select: kernel takes T <= {MAX_T}, "
                         f"C <= 8, 1 <= m <= T, got B={b}, T={t}, C={c}, "
                         f"m={m}, avg_width={avg_width}")
    per_warp = _imp_warp_bytes(t, c)
    tile = max(1, min(IMP_MAX_WARPS, -(-b // SMS), SMEM_DEFAULT // per_warp))
    smem = tile * per_warp
    return Geometry(tile=tile, group=32, blocks=-(-b // tile),
                    threads=32 * tile, smem=smem, optin=False,
                    variant=((0 if (c, avg_width) == (3, 8) else 1)
                             + (2 if t > 32 * IMP_STEPS[0] else 0)),
                    per_sm=_per_sm(32 * tile, smem, 1))


_LAUNCHES = {"signature_corr": 0, "fake_quant": 0, "kmeans_coreset": 0,
             "importance_select": 0}
_LIB: ctypes.CDLL | None = None


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        from .build import load
        _LIB = load()
    return _LIB


def _on_cuda(op: str, *tensors: torch.Tensor) -> bool:
    """True for all-CUDA operands, False for all-CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{op}: operands on {sorted(str(t.device) for t in tensors)}"
                     f"; the op runs on the CPU or on one CUDA device")


def _check(op: str, name: str, t: torch.Tensor, ndim: int | None) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{op}: {name} must be float32, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{op}: {name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def _launch(op: str, entry: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = getattr(kernel_library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {err}")
    _LAUNCHES[op] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def signature_corr_op(windows: torch.Tensor,
                      signatures: torch.Tensor) -> torch.Tensor:
    """(B, T, C) vs (L, T, C) -> (B, L) mean per-channel Pearson
    correlations: the fleet's memoization hot path, one call per slot."""
    op = "signature_corr"
    _check(op, "windows", windows, 3)
    _check(op, "signatures", signatures, 3)
    b, t, c = windows.shape
    l = signatures.shape[0]
    if signatures.shape[1:] != (t, c):
        raise ValueError(f"{op}: windows {tuple(windows.shape)} and "
                         f"signatures {tuple(signatures.shape)} disagree")
    if not _on_cuda(op, windows, signatures):
        return ref.signature_corr_ref(windows, signatures)
    geo = signature_corr_geometry(b, l, t, c)
    out = torch.empty((b, l), dtype=torch.float32, device=windows.device)
    _launch(op, "signature_corr_launch", windows.device, _ptr(windows),
            _ptr(signatures), _ptr(out), b, l, t, c, geo.tile, geo.blocks,
            geo.threads, geo.smem)
    return out


def fake_quant_op(x: torch.Tensor, bits: int, per_channel: bool = False,
                  per_sample: bool = False) -> torch.Tensor:
    """Fake-quantize ``x`` at ``bits`` precision.

    The scale is one per tensor (default), one per last-dim channel
    (``per_channel``), or one per leading index (``per_sample``: each node
    of a batched activation gets its own amax, as each node does under the
    JAX fleet's vmap).  On the card one kernel launch computes the whole
    function, amax and scale included (:func:`fake_quant_geometry`)."""
    op = "fake_quant"
    _check(op, "x", x, None)
    if per_channel and per_sample:
        raise ValueError(f"{op}: per_channel and per_sample exclude each other")
    if per_sample and x.ndim < 2:
        raise ValueError(f"{op}: per_sample needs a leading sample axis")
    x2d = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
    r, c = x2d.shape
    rows_per_group = r // x.shape[0] if per_sample else r
    if not _on_cuda(op, x):
        scale = ref.fake_quant_scale(x2d, bits, per_channel, rows_per_group)
        out = ref.fake_quant_ref(x2d, scale, bits, per_channel,
                                 rows_per_group)
        return out.reshape(x.shape)
    out = torch.empty_like(x)
    geo = fake_quant_geometry(x.numel(), c, r // rows_per_group, per_channel,
                              (x.data_ptr() | out.data_ptr()) % 16 == 0)
    # the cooperative kernels' (variants 2-5) scratch: each block's maxima,
    # written before they are read, so never zeroed; variant 5 also keeps
    # the column scales there
    words = (geo.blocks * (c if per_channel else 1)
             + (c if geo.variant == 5 else 0))
    partial = (torch.empty(words, dtype=torch.int32, device=x.device)
               if geo.variant >= 2 else None)
    qmax, rq = fake_quant_constants(bits)
    _launch(op, "fake_quant_launch", x.device, _ptr(x), _ptr(out),
            None if partial is None else _ptr(partial), x.numel(), c,
            rows_per_group * c, rq, qmax, geo.variant, geo.blocks,
            geo.threads, geo.smem)
    return out


def kmeans_coreset_op(points: torch.Tensor, k: int, iters: int = 4):
    """Batched clustering coresets: (B, N, D) -> (centers (B,k,D),
    radii (B,k), counts (B,k) int32)."""
    op = "kmeans_coreset"
    _check(op, "points", points, 3)
    b, n, d = points.shape
    if not _on_cuda(op, points):
        return ref.kmeans_coreset_ref(points, k, iters)
    geo = kmeans_coreset_geometry(b, n, d, k)
    dev = points.device
    centers = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    radii = torch.empty((b, k), dtype=torch.float32, device=dev)
    counts = torch.empty((b, k), dtype=torch.int32, device=dev)
    _launch(op, "kmeans_coreset_launch", dev, _ptr(points), _ptr(centers),
            _ptr(radii), _ptr(counts), b, n, d, k, iters, geo.variant,
            geo.blocks, geo.threads, geo.smem)
    return centers, radii, counts


def importance_select_op(windows: torch.Tensor, m: int, spread: float = 0.25,
                         avg_width: int = 8):
    """Deterministic top-m importance selection over a window batch:
    (B, T, C) -> (indices (B, m) int32 ascending, values (B, m, C),
    Horvitz-Thompson weights (B, m)).  The m indices of a window are
    distinct, even where weights tie (``spread=0`` on a flat window)."""
    op = "importance_select"
    _check(op, "windows", windows, 3)
    b, t, c = windows.shape
    if not 1 <= m <= t or avg_width < 1:
        raise ValueError(f"{op}: needs 1 <= m <= T and avg_width >= 1, got "
                         f"m={m}, T={t}, avg_width={avg_width}")
    if not _on_cuda(op, windows):
        return ref.importance_select_ref(windows, m, spread, avg_width)
    geo = importance_select_geometry(b, t, c, m, avg_width)
    dev = windows.device
    idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    vals = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    weights = torch.empty((b, m), dtype=torch.float32, device=dev)
    # the blend's constants as the plain version's float32 scalars round them
    _launch(op, "importance_select_launch", dev, _ptr(windows), _ptr(idx),
            _ptr(vals), _ptr(weights), b, t, c, m, avg_width, 1.0 - spread,
            spread / t, geo.variant, geo.tile, geo.blocks, geo.threads,
            geo.smem)
    return idx, vals, weights
