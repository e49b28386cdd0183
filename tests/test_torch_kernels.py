"""The port's kernel ops on the CPU, where each runs its plain PyTorch
version, against ``repro.kernels.ref`` and against the JAX ops with
``impl="pallas"`` (interpret mode, as tests/test_kernels.py runs them), at
that file's shapes and tolerances.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.

The quantizer is compared with the JAX functions as they run compiled (under
``jax.jit``, as the fleet engine and the Pallas wrapper run them): XLA
compiles the scale's division by the constant qmax to a multiply by its
reciprocal, and the port follows the compiled arithmetic.  Op-by-op JAX
divides instead, which for some amax moves a boundary element by a level.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.kernels import (fake_quant_op, importance_select_op,  # noqa: E402
                           kmeans_coreset_op, signature_corr_op)
from repro.kernels import ref  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as ops_ref  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CORR_TOL = dict(rtol=1e-4, atol=1e-5)
QUANT_TOL = dict(rtol=1e-5, atol=1e-6)
KMEANS_TOL = dict(rtol=1e-5, atol=1e-5)
IMP_VALS_TOL = dict(rtol=1e-5, atol=1e-6)
IMP_WEIGHTS_TOL = dict(rtol=1e-4, atol=1e-5)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# signature_corr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l", [(4, 5), (16, 12), (9, 3)])
def test_corr_plain_matches_jax(b, l):
    w, s = _normal(1, (b, 60, 3)), _normal(2, (l, 60, 3))
    got = ops.signature_corr_op(_t(w), _t(s)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.signature_corr_ref(w, s)),
                               **CORR_TOL)
    np.testing.assert_allclose(
        got, np.asarray(signature_corr_op(w, s, impl="pallas")), **CORR_TOL)
    assert np.all(np.abs(got) <= 1.0 + 1e-4)


def test_corr_self_correlation_is_one():
    w = _t(_normal(3, (5, 60, 3)))
    c = ops.signature_corr_op(w, w)
    np.testing.assert_allclose(torch.diag(c).numpy(), 1.0, atol=1e-4)


# ---------------------------------------------------------------------------
# fake_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("shape,per_channel", [
    ((33, 70), False), ((33, 70), True), ((4, 60, 3), False),
    ((4, 60, 3), True), ((256,), False)])
def test_quant_plain_matches_jax(bits, shape, per_channel):
    x = _normal(4, shape, 3.0)
    got = ops.fake_quant_op(_t(x), bits, per_channel=per_channel).numpy()
    x2d = x.reshape(-1, shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
    want = np.asarray(jax.jit(ref.fake_quant_ref, static_argnums=(1, 2))(
        x2d, bits, per_channel))
    np.testing.assert_allclose(got, want.reshape(shape), **QUANT_TOL)
    np.testing.assert_allclose(
        got, np.asarray(fake_quant_op(x, bits, per_channel=per_channel,
                                      impl="pallas")), **QUANT_TOL)


def test_quant_error_bound():
    x = _normal(5, (64, 64))
    for bits in (8, 12, 16):
        q = ops.fake_quant_op(_t(x), bits).numpy()
        scale = float(np.abs(x).max()) / (2 ** (bits - 1) - 1)
        assert float(np.abs(q - x).max()) <= scale / 2 + 1e-6


@pytest.mark.parametrize("bits", [12, 16])
@pytest.mark.parametrize("shape", [(6, 60, 3), (6, 30, 32), (6, 15, 64)])
def test_quant_per_sample_is_the_jax_fleet_vmap(bits, shape):
    """Under the JAX fleet's vmap each node's activation has its own amax:
    per_sample on (N, ...) equals JAX's op on x[i][None], vmapped over i."""
    x = _normal(6, shape) * np.linspace(0.1, 5.0, shape[0])[:, None, None]
    x = x.astype(np.float32)
    got = ops.fake_quant_op(_t(x), bits, per_sample=True).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda v: fake_quant_op(v[None], bits)[0]))(x))
    np.testing.assert_allclose(got, want, **QUANT_TOL)


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_quant_kernel_constant_is_the_plain_scale_multiplier(bits):
    """The rq the wrapper passes the kernel is the float32 constant
    ref.fake_quant_scale multiplies max(amax, 1e-9) by: a scale of amax 1
    is rq itself."""
    qmax, rq = ops.fake_quant_constants(bits)
    assert qmax == 2.0 ** (bits - 1) - 1.0
    plain = ops_ref.fake_quant_scale(torch.ones((1, 1)), bits, False, 1)
    assert plain.dtype == torch.float32
    assert plain.item() == rq
    assert np.float32(rq) == rq                 # exact in float32
    assert rq == float(np.float32(1.0) / np.float32(qmax))


def test_quant_rounds_half_to_even():
    # x / s lands exactly on .5: 127 levels at 8 bits, s = 1
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -2.5]])
    np.testing.assert_array_equal(ops.fake_quant_op(x, 8).numpy(),
                                  [[127.0, 0.0, 2.0, 2.0, -2.0]])


# ---------------------------------------------------------------------------
# kmeans_coreset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(60, 4), (32, 2), (64, 8)])
@pytest.mark.parametrize("k", [4, 12, 16])
def test_kmeans_plain_matches_ref(n, d, k, b=24):
    pts = _normal(7, (b, n, d))
    c1, r1, n1 = ops.kmeans_coreset_op(_t(pts), k)
    c2, r2, n2 = ref.kmeans_coreset_ref(pts, k=k)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), **KMEANS_TOL)
    np.testing.assert_allclose(r1.numpy(), np.asarray(r2), **KMEANS_TOL)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))
    assert n1.dtype == torch.int32


@pytest.mark.parametrize("b,n,d,k", [(8, 60, 2, 12), (9, 60, 4, 12)])
def test_kmeans_plain_matches_pallas(b, n, d, k):
    pts = _normal(8, (b, n, d))
    c1, r1, n1 = ops.kmeans_coreset_op(_t(pts), k)
    c2, r2, n2 = kmeans_coreset_op(pts, k=k, impl="pallas")
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), **KMEANS_TOL)
    np.testing.assert_allclose(r1.numpy(), np.asarray(r2), **KMEANS_TOL)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))


def test_kmeans_argmin_ties_go_to_lowest_index():
    # every point equidistant from centres 0 and 1 would flip an
    # index-unstable argmin; the first centre must take them all
    pts = torch.zeros((1, 4, 2))
    pts[0, :, 1] = torch.tensor([-1.0, 1.0, -1.0, 1.0])
    _, _, counts = ops.kmeans_coreset_op(pts, 2, iters=0)
    np.testing.assert_array_equal(counts.numpy(), [[4, 0]])


# ---------------------------------------------------------------------------
# importance_select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,c", [(4, 60, 3), (8, 48, 1), (13, 64, 5)])
@pytest.mark.parametrize("m", [8, 20])
def test_importance_plain_matches_jax(b, t, c, m):
    """Against both JAX paths at tests/test_kernels.py's shapes: indices
    exactly, values and weights at that file's tolerances."""
    w = _normal(9, (b, t, c))
    i1, v1, w1 = ops.importance_select_op(_t(w), m)
    assert i1.dtype == torch.int32 and tuple(v1.shape) == (b, m, c)
    for impl in ("ref", "pallas"):
        i2, v2, w2 = importance_select_op(w, m=m, impl=impl)
        np.testing.assert_array_equal(i1.numpy(), np.asarray(i2), impl)
        np.testing.assert_allclose(v1.numpy(), np.asarray(v2),
                                   **IMP_VALS_TOL)
        np.testing.assert_allclose(w1.numpy(), np.asarray(w2),
                                   **IMP_WEIGHTS_TOL)


def test_importance_flat_window_without_spread_keeps_distinct_indices():
    """spread=0 on a constant window: every weight is 0.  The port, like
    the JAX reference, picks the m lowest indices; the Pallas body repeats
    index 0 (ROADMAP Queue 3)."""
    w = np.ones((3, 60, 3), np.float32)
    idx, vals, weights = ops.importance_select_op(_t(w), 8, spread=0.0)
    i2, _, w2 = importance_select_op(w, m=8, spread=0.0, impl="ref")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i2))
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(8), (3, 1)))
    np.testing.assert_allclose(weights.numpy(), np.asarray(w2),
                               **IMP_WEIGHTS_TOL)
    np.testing.assert_array_equal(vals.numpy(), np.ones((3, 8, 3)))


def test_importance_ties_go_to_the_lower_index():
    # a window whose deviation is the same at every sample but one: the
    # remaining picks are the lowest indices
    w = np.zeros((1, 16, 1), np.float32)
    w[0, ::2, 0] = 1.0
    w[0, 9, 0] = 5.0
    idx, _, _ = ops.importance_select_op(_t(w), 4, avg_width=1)
    i2, _, _ = importance_select_op(w, m=4, avg_width=1, impl="pallas")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i2))


def _plain_weights(windows, spread=0.25, avg_width=8):
    """The (B, T) weights importance_select_ref ranks, in its arithmetic."""
    b, t, c = windows.shape
    pad_l = avg_width // 2
    pad_r = avg_width - 1 - pad_l
    xp = torch.cat([windows[:, :1].expand(b, pad_l, c), windows,
                    windows[:, -1:].expand(b, pad_r, c)], dim=1)
    acc = torch.zeros_like(windows)
    for j in range(avg_width):
        acc = acc + xp[:, j:j + t]
    dev = (windows - acc / avg_width).abs()
    detr = dev[..., 0]
    for ci in range(1, c):
        detr = detr + dev[..., ci]
    total = torch.zeros_like(detr[:, 0])
    for ti in range(t):
        total = total + detr[:, ti]
    w = detr / torch.clamp(total, min=1e-9)[:, None]
    return ((1.0 - spread) * w + spread / t).numpy()


def _rank_by_count(w, m):
    """importance_select.cu's selection in numpy, step by step: count the
    larger weights as the sign bits of float32 differences w[t] - w[u]
    (+0 added to every weight first); where those counts are not a
    permutation (their sum is not T(T-1)/2: some weights tie), add the
    equal weights before the step; pick the steps of rank < m and write
    each to the slot of the picks before it."""
    b, t = w.shape
    w = (w.astype(np.float32) + np.float32(0)).astype(np.float32)
    pad = -(-t // 4) * 4 - t                 # the -inf padding to a float4
    wp = np.concatenate([w, np.full((b, pad), -np.inf, np.float32)], axis=1)
    out = np.full((b, m), -1, np.int32)
    for i in range(b):
        diff = (w[i][:, None] - wp[i][None, :]).astype(np.float32)
        rank = (diff.view(np.uint32) >> 31).sum(axis=1)
        if rank.sum() != t * (t - 1) // 2:
            rank = rank + np.array([np.sum(w[i, :step] == w[i, step])
                                    for step in range(t)])
        picks = np.flatnonzero(rank < m)
        assert len(picks) == m
        out[i] = picks                      # ascending: slot = picks below
    return out


def _windows_with_levels(seed, shape, levels=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, shape).astype(np.float32)


@pytest.mark.parametrize("case,m", [
    ("random", 20), ("random", 1), ("random", 60), ("flat", 8),
    ("flat", 60), ("levels", 20), ("levels", 37), ("t37", 1), ("t37", 5),
    ("t37", 37), ("c5", 8)])
def test_importance_rank_by_count_picks_the_plain_indices(case, m):
    """The kernel's rank-by-count rule, emulated in numpy on the plain
    version's weights, picks exactly importance_select_ref's indices:
    random windows, flat windows with spread=0 (every weight 0), windows of
    three levels (many tied weights, also with spread=0), T=37 with m=1 and
    m=T, and the JAX tests' (13, 64, 5)."""
    spread = 0.25
    if case == "random":
        x = _normal(10, (16, 60, 3))
    elif case == "flat":
        x, spread = np.ones((4, 60, 3), np.float32), 0.0
    elif case == "levels":
        x = _windows_with_levels(11, (16, 60, 3))
        spread = 0.0 if m == 37 else 0.25
    elif case == "t37":
        x = _normal(12, (16, 37, 3))
    else:
        x = _normal(13, (13, 64, 5))
    idx, _, _ = ops_ref.importance_select_ref(_t(x), m, spread)
    w = _plain_weights(_t(x), spread)
    np.testing.assert_array_equal(_rank_by_count(w, m), idx.numpy())


@pytest.mark.parametrize("t", [5, 32, 37, 60, 64])
def test_rank_by_count_is_the_stable_descending_sort(t):
    """On weights with many exact ties, inside and across the two step
    sets, and on -0 against +0, the rule picks what a stable descending
    sort keeps."""
    rng = np.random.default_rng(t)
    w = rng.integers(0, 4, (64, t)).astype(np.float32) / 4
    w[:8] = 0.0
    w[8:16, ::3] = -0.0
    for m in sorted({1, t // 3 + 1, t}):
        order = np.argsort(-w, axis=1, kind="stable")[:, :m]
        np.testing.assert_array_equal(_rank_by_count(w, m),
                                      np.sort(order, axis=1))


# ---------------------------------------------------------------------------
# Wrapper contract
# ---------------------------------------------------------------------------

def test_wrappers_reject_bad_operands():
    x = torch.zeros((4, 60, 3), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ops.signature_corr_op(x, x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.kmeans_coreset_op(torch.zeros((4, 2, 60)).transpose(1, 2), 3)
    with pytest.raises(ValueError, match="disagree"):
        ops.signature_corr_op(torch.zeros((4, 60, 3)), torch.zeros((2, 50, 3)))
    with pytest.raises(ValueError, match="exclude"):
        ops.fake_quant_op(torch.zeros((4, 3)), 8, per_channel=True,
                          per_sample=True)
    with pytest.raises(ValueError, match="m <= T"):
        ops.importance_select_op(torch.zeros((2, 10, 3)), 11)


def test_cpu_ops_count_no_launches():
    ops.reset_launch_counts()
    ops.signature_corr_op(torch.zeros((2, 60, 3)), torch.ones((3, 60, 3)))
    ops.fake_quant_op(torch.ones((2, 3)), 8)
    ops.kmeans_coreset_op(torch.zeros((2, 60, 2)), 4)
    ops.importance_select_op(torch.ones((2, 60, 3)), 8)
    assert ops.launch_counts() == {"signature_corr": 0, "fake_quant": 0,
                                   "kmeans_coreset": 0,
                                   "importance_select": 0}


def test_ops_import_and_cpu_path_need_no_nvcc():
    code = ("import torch; from repro_torch.kernels import ops; "
            "print(ops.fake_quant_op(torch.ones(2, 3), 8).sum().item())")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_HOME": "/nonexistent"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env)
    assert out.stdout.strip() == "6.0"


# ---------------------------------------------------------------------------
# Launch geometry (pure Python: the CUDA side refuses any other)
# ---------------------------------------------------------------------------

# the fleet's shapes: one slot's (N, T, C) windows against the 12-class bank,
# the N * C channel clouds of 60 (t, x) points with k = 12; and the smaller
# batches of node_block
@pytest.mark.parametrize("nodes", [3000, 1000, 12, 1])
def test_geometry_fleet_shapes_are_one_wave(nodes):
    corr = ops.signature_corr_geometry(nodes, 12, 60, 3)
    km = ops.kmeans_coreset_geometry(nodes * 3, 60, 2, 12)
    for geo in (corr, km):
        assert geo.waves == 1
        assert geo.blocks <= ops.SMS * geo.per_sm
    assert corr.variant == 3 and not corr.optin
    assert km.variant == 0 and km.group == 8 and not km.optin
    if nodes == 3000:
        assert corr.blocks <= ops.SMS < corr.blocks + 2      # ~1 block an SM
        assert km.blocks == 1125 and km.per_sm >= 9


_CORR_SHAPES = [(b, l, t, c) for b in (1, 13, 3000, 250_000)
                for t, c in ((1, 1), (37, 1), (60, 3), (61, 2), (64, 4),
                             (65, 1), (120, 1), (128, 4))
                for l in (1, 12, 47)
                if (l * t * c + l * c) * 4 <= 48 * 1024]
_KMEANS_SHAPES = [(b, n, d, k) for b in (1, 999, 9000)
                  for n in (1, 13, 37, 60, 64, 65, 120, 128)
                  for d in (1, 2, 3, 4)
                  for k in (1, 5, 12, 16, 17, 32)]


@pytest.mark.parametrize("kernel", ["signature_corr", "kmeans_coreset"])
def test_geometry_covers_the_accepted_range(kernel):
    if kernel == "signature_corr":
        cases = [(s, ops.signature_corr_geometry(*s)) for s in _CORR_SHAPES]
    else:
        cases = [(s, ops.kmeans_coreset_geometry(*s)) for s in _KMEANS_SHAPES]
    for shape, geo in cases:
        b = shape[0]
        assert geo.smem <= 227 * 1024, (shape, geo)
        assert geo.optin == (geo.smem > 48 * 1024), (shape, geo)
        assert 32 <= geo.threads <= 1024 and geo.threads % 32 == 0
        assert geo.blocks == -(-b // geo.tile)                # every item,
        assert (geo.blocks - 1) * geo.tile < b                # no idle block
        if kernel == "signature_corr":
            l, t, c = shape[1:]
            assert geo.variant == c and geo.group == 0
            assert geo.threads >= min(geo.tile * l, 1024)
        else:
            n, d, k = shape[1:]
            kmax, dmax, nmax, _ = ops.KMEANS_VARIANTS[geo.variant]
            assert k <= kmax and d <= dmax and n <= nmax
            small = k <= 16 and d <= 2
            assert geo.variant == ((0 if small else 1) if n <= 64
                                   else (2 if d <= 2 else 3))
            assert geo.tile * geo.group == geo.threads


def test_geometry_opt_in_above_48_kb():
    # the widest clouds' partial sums, and a bank of 47 x 64 x 4 with a big
    # tile, need more than the default 48 KB
    km = ops.kmeans_coreset_geometry(999, 64, 4, 32)
    assert km.variant == 1 and km.optin and km.smem == 57_888
    km = ops.kmeans_coreset_geometry(999, 128, 4, 32)
    assert km.variant == 3 and km.optin and km.smem == 66_080
    corr = ops.signature_corr_geometry(250_000, 47, 64, 4)
    assert corr.optin and corr.smem <= 227 * 1024


# one slot's per-node activations (D2, and the lanes' stages) and the HAR
# weights, at the fleet's node counts
_FQ_ACTS = [(60, 3), (30, 32), (15, 64)]
_HAR_WEIGHTS = [(5, 3, 32), (5, 32, 64), (960, 128), (128, 12)]


@pytest.mark.parametrize("nodes", [3, 300, 3000])
def test_quant_and_importance_geometry_fleet_shapes_are_one_wave(nodes):
    for t, c in _FQ_ACTS:
        geo = ops.fake_quant_geometry(nodes * t * c, c, nodes, False, True)
        assert geo.variant == 0 and geo.group == 32 and geo.tile == 8
        assert geo.blocks == -(-nodes // 8) and geo.waves == 1
        assert geo.threads == ops.FQ_THREADS and geo.smem == 0
        assert t * c <= 32 * 4 * ops.FQ_HELD     # held in registers
    for shape in _HAR_WEIGHTS:
        n = int(np.prod(shape))
        geo = ops.fake_quant_geometry(n, shape[-1], 1, False, True)
        assert geo.variant == 2 and geo.waves == 1
        assert geo.blocks * geo.threads * 4 * ops.FQ_HELD >= n
    imp = ops.importance_select_geometry(nodes, 60, 3, 20, 8)
    assert imp.variant == 0 and imp.waves == 1 and imp.blocks <= ops.SMS
    assert imp.tile == -(-nodes // ops.SMS) and imp.threads == 32 * imp.tile
    assert imp.smem <= 48 * 1024 and not imp.optin
    if nodes == 3000:
        assert imp.blocks == 131 and imp.tile == 23


_FQ_SHAPES = [(numel, cols, groups, per_channel, aligned)
              for groups, size in ((1, 1), (1, 273), (1, 480), (1, 122_880),
                                   (1, 8_388_608), (1, 40_000_000),
                                   (7, 39), (3000, 180), (3000, 960),
                                   (64, 2560), (16, 903), (5, 100_000),
                                   (250_000, 180))
              for numel, cols in ((groups * size, 3 if size % 3 == 0 else 1),)
              for per_channel in (False, True)
              for aligned in (False, True)
              if not per_channel or groups == 1] + [
    (rows * cols, cols, 1, True, aligned)
    for rows, cols in ((4096, 4096), (1, 4097), (256, 8192), (3, 100_003))
    for aligned in (False, True)]


def test_fake_quant_geometry_covers_the_accepted_range():
    for numel, cols, groups, per_channel, aligned in _FQ_SHAPES:
        geo = ops.fake_quant_geometry(numel, cols, groups, per_channel,
                                      aligned)
        case = (numel, cols, groups, per_channel, aligned, geo)
        assert geo.threads == ops.FQ_THREADS and not geo.optin, case
        assert geo.per_sm == ops.FQ_PER_SM, case
        size = numel // groups
        if per_channel:
            wide = cols > ops.FQ_MAX_COLS
            assert geo.variant == (5 if wide else 4), case
            assert 1 <= geo.blocks <= ops.SMS, case        # co-resident
            assert geo.smem == (0 if wide else 4 * cols) <= 48 * 1024, case
        elif groups == 1:
            vec = aligned and size % 4 == 0
            assert geo.variant == (2 if vec else 3), case
            assert 1 <= geo.blocks <= ops.SMS * ops.FQ_PER_SM, case
            assert geo.waves == 1 and geo.smem == 0, case
            items = size // 4 if vec else size
            assert (geo.blocks - 1) * geo.threads * ops.FQ_HELD < items, case
        else:
            vec = aligned and size % 4 == 0
            assert geo.variant == (0 if vec else 1), case
            assert geo.group == 32 and geo.tile * 32 == geo.threads, case
            assert geo.blocks == -(-groups // geo.tile), case
            assert (geo.blocks - 1) * geo.tile < groups, case
            assert geo.smem == 0, case


@pytest.mark.parametrize("args", [
    (0, 3, 1, False, True), (10, 3, 1, False, True), (12, 3, 5, False, True),
    (12, 0, 1, False, True), (8192, 3, 1, True, True),
    (60, 3, 2, True, True), (2 ** 31 * 3, 3, 1, False, True)])
def test_fake_quant_geometry_rejects_out_of_range(args):
    with pytest.raises(ValueError, match="fake_quant: kernel takes"):
        ops.fake_quant_geometry(*args)


_IMP_SHAPES = [(b, t, c, m, width) for b in (1, 13, 3000, 250_000)
               for t, c in ((1, 1), (37, 3), (60, 3), (64, 5), (64, 8),
                            (65, 3), (120, 1), (128, 8))
               for m in sorted({1, min(20, t), t})
               for width in (1, 5, 8)]


def test_importance_geometry_covers_the_accepted_range():
    for shape in _IMP_SHAPES:
        b, t, c, m, width = shape
        geo = ops.importance_select_geometry(*shape)
        assert geo.group == 32 and 1 <= geo.tile <= ops.IMP_MAX_WARPS, shape
        assert geo.threads == 32 * geo.tile <= 1024, shape
        assert geo.blocks == -(-b // geo.tile), shape           # every window,
        assert (geo.blocks - 1) * geo.tile < b, shape           # no idle block
        assert geo.smem <= 48 * 1024 and not geo.optin, shape
        per_warp = 4 * (-(-t * c // 4) * 4 + -(-t // 4) * 4)
        assert geo.smem == geo.tile * per_warp, shape
        assert geo.variant == ((0 if (c, width) == (3, 8) else 1)
                               + (2 if t > 64 else 0)), shape
        if b <= ops.SMS * min(ops.IMP_MAX_WARPS, 48 * 1024 // per_warp):
            assert geo.waves == 1, shape


@pytest.mark.parametrize("shape", [(10, 129, 3, 8, 8), (10, 60, 9, 8, 8),
                                   (10, 60, 3, 0, 8), (10, 60, 3, 61, 8),
                                   (10, 60, 3, 8, 0), (0, 60, 3, 8, 8)])
def test_importance_geometry_rejects_out_of_range(shape):
    with pytest.raises(ValueError, match="T <= 128, C <= 8"):
        ops.importance_select_geometry(*shape)


@pytest.mark.parametrize("shape", [(10, 12, 129, 3), (10, 12, 60, 5),
                                   (10, 48, 64, 4), (10, 0, 60, 3),
                                   (10, 12, 0, 3)])
def test_signature_corr_geometry_rejects_out_of_range(shape):
    with pytest.raises(ValueError, match="T <= 128, C <= 4"):
        ops.signature_corr_geometry(*shape)


@pytest.mark.parametrize("shape", [(10, 129, 2, 12), (10, 60, 5, 12),
                                   (10, 60, 2, 33), (10, 60, 2, 0),
                                   (10, 0, 2, 4)])
def test_kmeans_geometry_rejects_out_of_range(shape):
    with pytest.raises(ValueError, match="N <= 128, D <= 4, k <= 32"):
        ops.kmeans_coreset_geometry(*shape)


# ---------------------------------------------------------------------------
# The bearing config's shapes: 120-sample windows, one channel, k = 18
# (repro.configs.seeker_har.BEARING, SYSTEM.bearing_clusters), and a
# per-channel quantizer wider than a block's shared memory holds
# ---------------------------------------------------------------------------

BEARING_T, BEARING_K = 120, 18


def test_geometry_takes_the_bearing_shapes():
    corr = ops.signature_corr_geometry(3000, 10, BEARING_T, 1)
    km = ops.kmeans_coreset_geometry(3000, BEARING_T, 2, BEARING_K)
    imp = ops.importance_select_geometry(3000, BEARING_T, 1, 20, 8)
    fq = ops.fake_quant_geometry(256 * 8192, 8192, 1, True, True)
    assert corr.variant == 1 and corr.waves == 1
    assert ops.KMEANS_VARIANTS[km.variant][:3] == (32, 2, 128)
    assert km.waves == 1 and not km.optin
    assert imp.variant == 3 and imp.waves == 1
    assert fq.variant == 5 and fq.blocks == ops.SMS and fq.smem == 0
    # the fleet's shapes keep their instantiations
    assert ops.kmeans_coreset_geometry(9000, 60, 2, 12).variant == 0
    assert ops.importance_select_geometry(3000, 60, 3, 20, 8).variant == 0


def test_bearing_shapes_plain_match_jax():
    """The CPU path of each op at the bearing shapes against the JAX op
    (Pallas in interpret mode), at this file's tolerances."""
    w = _normal(21, (6, BEARING_T, 1))
    s = _normal(22, (10, BEARING_T, 1))
    np.testing.assert_allclose(
        ops.signature_corr_op(_t(w), _t(s)).numpy(),
        np.asarray(signature_corr_op(w, s, impl="pallas")), **CORR_TOL)

    t = np.linspace(0.0, 1.0, BEARING_T, dtype=np.float32)
    pts = np.stack([np.broadcast_to(t, (6, BEARING_T)), w[..., 0]], -1)
    c1, r1, n1 = ops.kmeans_coreset_op(_t(pts), BEARING_K)
    c2, r2, n2 = kmeans_coreset_op(pts, k=BEARING_K, impl="pallas")
    np.testing.assert_allclose(c1.numpy(), np.asarray(c2), **KMEANS_TOL)
    np.testing.assert_allclose(r1.numpy(), np.asarray(r2), **KMEANS_TOL)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))

    i1, v1, w1 = ops.importance_select_op(_t(w), 20)
    i2, v2, w2 = importance_select_op(w, m=20, impl="pallas")
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
    np.testing.assert_allclose(v1.numpy(), np.asarray(v2), **IMP_VALS_TOL)
    np.testing.assert_allclose(w1.numpy(), np.asarray(w2), **IMP_WEIGHTS_TOL)


@pytest.mark.parametrize("bits", [8, 16])
def test_quant_per_channel_wide_plain_matches_jax(bits):
    x = _normal(23, (4, 8192), 3.0) * np.linspace(
        0.5, 2.0, 8192, dtype=np.float32)
    x = x.astype(np.float32)
    got = ops.fake_quant_op(_t(x), bits, per_channel=True).numpy()
    want = np.asarray(jax.jit(ref.fake_quant_ref, static_argnums=(1, 2))(
        x, bits, True))
    np.testing.assert_allclose(got, want, **QUANT_TOL)
    np.testing.assert_allclose(
        got, np.asarray(fake_quant_op(x, bits, per_channel=True,
                                      impl="pallas")), **QUANT_TOL)


def test_ptxas_report_reads_registers_and_spills():
    log = """--- kmeans_coreset.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi16ELi2EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi16ELi2EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi32ELi4EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi32ELi4EEvPKf
    8 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]
"""
    assert build.ptxas_report(log) == {
        "_Z6kernelILi16ELi2EEvPKf": dict(registers=78, spill_stores=0,
                                         spill_loads=0),
        "_Z6kernelILi32ELi4EEvPKf": dict(registers=64, spill_stores=24,
                                         spill_loads=32)}
    assert build.ptxas_report("") == {}


def test_build_names_library_by_source_hash():
    path = build.library_path()
    assert path.parent == REPO / "build" / "repro_torch"
    assert path.name.startswith("librepro_torch_kernels-")
    assert {p.name for p in build.CSRC.glob("*.cu")} == {
        "signature_corr.cu", "fake_quant.cu", "kmeans_coreset.cu",
        "importance_select.cu"}
    assert set(build._ENTRY_POINTS) == {
        p.stem + "_launch" for p in build.CSRC.glob("*.cu")}
    # the two kernels that take their geometry from ops.py: pointers, the
    # shape, then (tile or variant, blocks, threads, shared-memory bytes),
    # then the stream
    assert len(build._ENTRY_POINTS["signature_corr_launch"]) == 3 + 4 + 4 + 1
    assert len(build._ENTRY_POINTS["kmeans_coreset_launch"]) == 4 + 5 + 4 + 1
    # fake_quant: x, out, scratch, then numel, cols, group floats, rq, qmax,
    # then (variant, blocks, threads, shared-memory bytes); importance:
    # four pointers, B, T, C, m, width, keep, floor, then (variant, tile,
    # blocks, threads, shared-memory bytes)
    assert len(build._ENTRY_POINTS["fake_quant_launch"]) == 3 + 5 + 4 + 1
    assert len(build._ENTRY_POINTS["importance_select_launch"]) == (
        4 + 7 + 5 + 1)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
