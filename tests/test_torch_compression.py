"""The gradient and activation codecs of ``repro_torch.core.compression``
against ``repro.core.compression``, on the same numpy inputs, on the CPU:
top-k (ties included) and block top-k, the 1-D k-means coreset and its
dithered recovery, the activation codec, the wire-byte formulas, and
``coreset_allreduce`` for one rank in-process and for two gloo ranks
against JAX's two-device ``shard_map`` in subprocesses, with the
compressed train step on top.

Integer outputs (indices, offsets, codes, counts) must equal JAX's
exactly; floats within rtol 1e-5, atol 1e-6 unless a test says otherwise.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.core import compression as jc  # noqa: E402
from repro.sharding import make_mesh_compat, shard_map_compat  # noqa: E402

from repro_torch.core import compression as tc  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _grad_like(seed, n, zero_frac=0.5):
    """A gradient-like vector: normal entries with a share of exact zeros
    (rows no token touched) and repeated magnitudes of either sign."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.random(n) < zero_frac] = 0.0
    x[: n // 8] = np.round(x[: n // 8] * 4) / 4          # ties in |x|
    return x


# ---------------------------------------------------------------------------
# Top-k
# ---------------------------------------------------------------------------

def test_topk_ties_go_to_the_lowest_index_as_in_jax():
    """|[0, 3, 0, -3, 0, 1, 0]| with k=5: JAX keeps [1 3 5 0 2]
    (``torch.topk`` would give [1 3 5 4 6])."""
    x = np.array([0, 3, 0, -3, 0, 1, 0], np.float32)
    jv, ji = jc.topk_compress(jnp.asarray(x), 5)
    tv, ti = tc.topk_compress(torch.as_tensor(x), 5)
    _equal(ti, [1, 3, 5, 0, 2])
    _equal(ti, ji)
    _equal(tv, jv)
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("seed,n,k", [(0, 4096, 64), (1, 10000, 156),
                                      (2, 2049, 2049), (3, 300, 1)])
def test_topk_compress_and_decompress_match_jax(seed, n, k):
    x = _grad_like(seed, n)
    jv, ji = jc.topk_compress(jnp.asarray(x), k)
    tv, ti = tc.topk_compress(torch.as_tensor(x), k)
    _equal(ti, ji)
    _equal(tv, jv)
    _equal(tc.topk_decompress(tv, ti, n), jc.topk_decompress(jv, ji, n))


@pytest.mark.parametrize("seed,n,block,ratio", [
    (0, 65536, 32768, 1 / 64), (1, 8192, 1024, 1 / 16),
    (2, 4096, 4096, 1 / 100)])
def test_topk_block_codec_matches_jax(seed, n, block, ratio):
    x = _grad_like(seed, n)
    jv, jo = jc.topk_block_compress(jnp.asarray(x), ratio, block)
    tv, to = tc.topk_block_compress(torch.as_tensor(x), ratio, block)
    assert to.dtype == torch.int16
    _equal(to, jo)
    _equal(tv, jv)
    _equal(tc.topk_block_decompress(tv, to, n),
           jc.topk_block_decompress(jv, jo, n))
    with pytest.raises(ValueError, match="multiple"):
        tc.topk_block_compress(torch.as_tensor(x[:-1]), ratio, block)


# ---------------------------------------------------------------------------
# 1-D k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,k,iters", [(0, 2048, 16, 4), (1, 4096, 8, 4),
                                            (2, 1000, 4, 2), (3, 513, 16, 0)])
def test_kmeans1d_matches_jax(seed, n, k, iters):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    want = jc.kmeans1d(jnp.asarray(x), k, iters)
    got = tc.kmeans1d(torch.as_tensor(x), k, iters)
    _equal(got.codes, want.codes)
    _equal(got.counts, want.counts)
    assert got.codes.dtype == got.counts.dtype == torch.int32
    _close(got.centers, want.centers)
    _close(got.radii, want.radii)
    _close(tc.kmeans1d_decompress(got), jc.kmeans1d_decompress(want))


def test_kmeans1d_dither_with_jax_draws():
    """The dithered recovery with JAX's uniform draws injected as ``u``;
    and from a generator, every value within its cluster's radius."""
    x = np.random.default_rng(5).standard_normal(3000).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jc.kmeans1d_decompress(jc.kmeans1d(jnp.asarray(x)), key)
    u = jax.random.uniform(key, (3000,), minval=-1.0, maxval=1.0)
    cs = tc.kmeans1d(torch.as_tensor(x))
    _close(tc.kmeans1d_decompress(cs, u=torch.as_tensor(np.array(u))),
           want)
    drawn = tc.kmeans1d_decompress(cs, generator=torch.Generator()
                                   .manual_seed(0))
    base = cs.centers[cs.codes.long()]
    assert bool(((drawn - base).abs()
                 <= cs.radii[cs.codes.long()] + 1e-6).all())
    assert not torch.equal(drawn, base)


def test_activation_codec_matches_jax():
    x = np.random.default_rng(6).standard_normal((4, 33, 16)).astype(
        np.float32)
    cfg_j, cfg_t = jc.CompressionConfig(kmeans_k=8), tc.CompressionConfig(
        kmeans_k=8)
    want_cs = jc.compress_activation(jnp.asarray(x), cfg_j)
    got_cs = tc.compress_activation(torch.as_tensor(x), cfg_t)
    _equal(got_cs.codes, want_cs.codes)
    got = tc.decompress_activation(got_cs, x.shape, torch.bfloat16)
    want = jc.decompress_activation(want_cs, x.shape, jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _equal(got.float(), np.asarray(want, np.float32))


def test_wire_bytes_and_config_equal_jax():
    for n, ndev in [(1 << 20, 8), (12345, 2), (1, 1)]:
        assert tc.wire_bytes_dense_psum(n, ndev) == jc.wire_bytes_dense_psum(
            n, ndev)
        assert tc.wire_bytes_topk_allgather(n, ndev, 1 / 64) == \
            jc.wire_bytes_topk_allgather(n, ndev, 1 / 64)
        assert tc.wire_bytes_kmeans1d(n) == jc.wire_bytes_kmeans1d(n)
    assert dataclasses.asdict(tc.CompressionConfig()) == dataclasses.asdict(
        jc.CompressionConfig())


# ---------------------------------------------------------------------------
# coreset_allreduce, one rank
# ---------------------------------------------------------------------------

def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"big": _grad_like(seed, 6000).reshape(60, 100),
            "small": rng.standard_normal((8, 16)).astype(np.float32),
            "stack": [_grad_like(seed + 1, 4096).reshape(2, 2048)]}


def _jax_allreduce_one_device(grads, cfg, ef):
    mesh = make_mesh_compat((1,), ("data",))
    spec = jax.tree_util.tree_map(lambda _: jax.sharding.PartitionSpec(),
                                  grads)
    fn = shard_map_compat(
        lambda g, e: jc.coreset_allreduce(g, ("data",), cfg, e), mesh,
        in_specs=(spec, spec if ef is not None else None),
        out_specs=(spec, spec), axis_names=frozenset({"data"}))
    return jax.jit(fn)(grads, ef)


@pytest.mark.parametrize("method,feedback", [("topk", True),
                                             ("topk", False),
                                             ("topk_block", True),
                                             ("none", True)])
def test_coreset_allreduce_one_rank_matches_jax(method, feedback):
    """With no process group the port runs JAX's one-device reduction:
    the bf16 wire rounding of the kept entries, zeros elsewhere, and the
    residuals (small leaves pass through with a zero residual)."""
    from repro_torch.tree import leaves
    kw = dict(method=method, error_feedback=feedback, block=1024)
    grads = _grad_tree(0)
    ef = _grad_tree(1) if feedback else None
    jm, je = _jax_allreduce_one_device(
        jax.tree_util.tree_map(jnp.asarray, grads), jc.CompressionConfig(**kw),
        None if ef is None else jax.tree_util.tree_map(jnp.asarray, ef))
    to_t = lambda t: jax.tree_util.tree_map(torch.as_tensor, t)  # noqa: E731
    tm, te = tc.coreset_allreduce(to_t(grads), None,
                                  tc.CompressionConfig(**kw),
                                  None if ef is None else to_t(ef))
    for got, want in zip(leaves(tm) + leaves(te),
                         jax.tree_util.tree_leaves(jm)
                         + jax.tree_util.tree_leaves(je)):
        _equal(got, want)


# ---------------------------------------------------------------------------
# coreset_allreduce and the compressed step over two ranks
# ---------------------------------------------------------------------------

_JAX_TWO_DEVICES = """
import pickle
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import compression as jc
from repro.models.config import ModelConfig
from repro.sharding import make_mesh_compat, shard_map_compat
from repro.train import TrainHyper, make_compressed_train_step

bundle = dict(np.load(sys.argv[1]))
mesh = make_mesh_compat((2,), ("data",))
out = {}
for method in ("topk", "topk_block"):
    cfg = jc.CompressionConfig(method=method, block=1024)
    names = sorted(k for k in bundle if k.startswith("g_"))
    g = {k: jnp.asarray(bundle[k]) for k in names}
    e = {k: jnp.asarray(bundle["e" + k[1:]]) for k in names}
    spec = {k: P("data") for k in names}

    def body(g, e):
        g = {k: v[0] for k, v in g.items()}
        e = {k: v[0] for k, v in e.items()}
        m, r = jc.coreset_allreduce(g, ("data",), cfg, e)
        return ({k: v[None] for k, v in m.items()},
                {k: v[None] for k, v in r.items()})

    m, r = jax.jit(shard_map_compat(body, mesh, in_specs=(spec, spec),
                                    out_specs=(spec, spec)))(g, e)
    for k in names:
        out[f"{method}/mean/{k}"] = np.asarray(m[k])
        out[f"{method}/ef/{k}"] = np.asarray(r[k])

mcfg = ModelConfig(name="t", vocab=64, d_model=32, n_layers=2, n_heads=4,
                   n_kv=2, d_ff=64, dtype=jnp.float32)
hyper = TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10)
ccfg = jc.CompressionConfig(topk_ratio=1 / 16, min_size=1024)
with open(sys.argv[1][:-len(".npz")] + ".pkl", "rb") as f:
    state = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
step = jax.jit(make_compressed_train_step(mcfg, hyper, ccfg, mesh, ("data",)))
for i in range(2):
    state, met = step(state, {"tokens": jnp.asarray(bundle[f"tokens{i}"])})
    out[f"step{i}/loss"] = np.asarray(met["loss"])
    out[f"step{i}/grad_norm"] = np.asarray(met["grad_norm"])
for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
    out["state/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _two_rank_bundle(tmp_path):
    """Per-rank gradients and residuals (leading dim: the rank) and two
    global batches of 8 in ``bundle.npz``, and a tiny model's train state
    (numpy leaves) in ``bundle.pkl``."""
    from repro.data.lm import LMTask, lm_batches
    from repro.models.config import ModelConfig
    from repro.train import TrainHyper, init_train_state
    rng = np.random.default_rng(11)
    bundle = {}
    for name, shape in [("g_a", (2, 6000)), ("g_b", (2, 40, 64)),
                        ("g_c", (2, 16, 8))]:
        x = rng.standard_normal(shape).astype(np.float32)
        x[rng.random(shape) < 0.3] = 0.0
        bundle[name] = x
        bundle["e" + name[1:]] = 0.01 * rng.standard_normal(shape).astype(
            np.float32)
    mcfg = ModelConfig(name="t", vocab=64, d_model=32, n_layers=2, n_heads=4,
                       n_kv=2, d_ff=64, dtype=jnp.float32)
    state = init_train_state(jax.random.PRNGKey(3), mcfg,
                             TrainHyper(peak_lr=1e-3, warmup=1,
                                        total_steps=10),
                             jc.CompressionConfig(topk_ratio=1 / 16,
                                                  min_size=1024))
    state_np = jax.tree_util.tree_map(np.asarray, state)
    with open(tmp_path / "bundle.pkl", "wb") as f:
        pickle.dump(state_np, f)
    task = LMTask(vocab=64, seq_len=32, batch=8)
    for i in range(2):
        bundle[f"tokens{i}"] = np.asarray(lm_batches(task, i)["tokens"])
    path = tmp_path / "bundle.npz"
    np.savez(path, **bundle)
    return path, state_np


def test_two_gloo_ranks_match_jax_two_devices(tmp_path):
    """Two gloo ranks against JAX's two host devices: ``coreset_allreduce``
    on the same per-rank gradients and residuals (means and residuals
    exactly equal, both codecs), and two steps of the compressed train
    step from JAX's initial state on the same batches: loss within 1e-5,
    both ranks' parameters and optimizer states bitwise equal to each
    other, and rank 0's state (its error-feedback residuals included: JAX
    returns device 0's) within 1e-5 of JAX's but for the bf16 rounding
    flips :func:`_close_but_bf16_flips` bounds (the rank-local grads differ
    from JAX's by float rounding)."""
    bundle, _ = _two_rank_bundle(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jax_out = tmp_path / "jax.npz"
    jproc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_TWO_DEVICES), str(bundle),
         str(jax_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    store = tmp_path / "store"
    worker = REPO / "tests" / "_torch_train_worker.py"
    ranks = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "2", str(store), str(bundle),
         str(tmp_path / f"rank{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in ranks + [jproc]:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    want = dict(np.load(jax_out))
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    for r, res in enumerate(got):
        for key, val in res["allreduce"].items():
            method, kind, name = key.split("/")
            _equal(val, want[key][r])
    assert got[0]["state"].keys() == got[1]["state"].keys()
    for name in got[0]["state"]:
        if not name.startswith("['ef']"):       # each rank's own residuals
            assert torch.equal(got[0]["state"][name],
                               got[1]["state"][name]), name
    for i in range(2):
        _close(got[0]["metrics"][i]["loss"], want[f"step{i}/loss"],
               rtol=1e-5, atol=1e-5)
        _close(got[0]["metrics"][i]["grad_norm"],
               want[f"step{i}/grad_norm"], rtol=1e-4, atol=1e-5)
    jstate = {k[len("state/"):]: v for k, v in want.items()
              if k.startswith("state/")}
    assert len(jstate) == len(got[0]["state"])
    flips = 0
    for name, val in got[0]["state"].items():
        flips += _close_but_bf16_flips(val, jstate[name], name)
    print(f"elements beyond 1e-5 of JAX's, each within a bf16 step: {flips}")


def _close_but_bf16_flips(got, want, what: str) -> int:
    """``got`` within rtol 1e-5, atol 1e-5 of ``want``, but for at most 0.1%
    of the elements, each within 2**-7 of the leaf's largest magnitude: a
    kept gradient entry whose float32 value lies within rounding of a
    bfloat16 rounding boundary goes on the wire one bf16 step (2**-7
    relative at most) away from JAX's, and that step reaches its mean
    grad, moments, parameter and residual.  Returns the count of such
    elements."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    off = diff > 1e-5 + 1e-5 * np.abs(want)
    assert off.mean() <= 1e-3, (what, int(off.sum()), off.size)
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert (diff[off] <= 2.0 ** -7 * scale).all(), (what, diff.max(), scale)
    return int(off.sum())
