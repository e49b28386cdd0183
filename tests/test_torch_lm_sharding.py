"""The LM half of ``repro_torch.sharding`` against ``repro.sharding``, on
the CPU.

In-process and exact: the rule tables, the parameter and cache spec trees
and their abstract (``meta``) trees for all ten configs, the optimizer and
train state specs, ``spec_for`` on every parameter leaf of the ten configs
on five meshes under the four rule tables (JAX's reads only
``mesh.shape``, so a namespace stands in for a mesh without devices), the
placements a resolved spec gives, ``constrain`` outside a context and
``named_sharding`` without a mesh.

Across ranks: four gloo ranks (``tests/_torch_lm_sharding_worker.py``) on
a (2, 2) ("data", "model") mesh beside one JAX subprocess on four host
devices, from the same numpy-drawn states and batches: the FSDP step, the
DP+TP compressed step, the MoE, RG-LRU and pure-DP steps, a JAX checkpoint
restored onto the mesh and a preempted sharded run; and one gloo rank on a
(1, 1) mesh against the unsharded steps.  Floats within rtol 1e-5, atol
1e-5 unless a test says otherwise; integers (the codec's indices, local
shapes, offsets) exact.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro import checkpoint as jckpt  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import sharding as jshd  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.compression import CompressionConfig as JComp  # noqa: E402

from repro_torch import models as tmodels  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import sharding as tshd  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import train_state  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.data.lm import LMTask, lm_batches  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
sys.path.insert(0, str(TESTS))
from test_torch_compression import _close_but_bf16_flips  # noqa: E402
from test_torch_lm import _jcfg, _params, _smoke, _tokens  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _spec_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda s: isinstance(s, tuple) and all(
            isinstance(e, (str, type(None))) for e in s))


# ---------------------------------------------------------------------------
# Rule tables, spec trees, abstract trees
# ---------------------------------------------------------------------------

def test_rule_tables_equal_jax():
    for name in ("FSDP_RULES", "DP_TP_RULES", "PURE_DP_RULES", "FLEET_RULES",
                 "DEFAULT_RULES"):
        assert dict(getattr(tshd, name)) == dict(getattr(jshd, name)), name
    assert tshd.DEFAULT_RULES is tshd.FSDP_RULES


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_equal_jax(arch):
    """``param_specs`` and ``cache_specs`` tuple for tuple, and the shapes
    and dtypes of ``abstract_params`` and ``abstract_cache``, in the same
    tree, for the full config."""
    jc, tc = j_get_config(arch), t_get_config(arch)
    assert _spec_leaves(tmodels.param_specs(tc)) == _spec_leaves(
        jmodels.param_specs(jc))
    assert jax.tree_util.tree_structure(
        tmodels.param_specs(tc), is_leaf=lambda s: isinstance(s, tuple)) == \
        jax.tree_util.tree_structure(jmodels.param_specs(jc),
                                     is_leaf=lambda s: isinstance(s, tuple))

    def meta(tree):
        assert all(t.device.type == "meta" for t in leaves(tree))
        return [(tuple(t.shape), str(t.dtype).split(".")[1])
                for t in leaves(tree)]

    def sds(tree):
        return [(tuple(s.shape), str(s.dtype))
                for s in jax.tree_util.tree_leaves(tree)]

    assert meta(tmodels.abstract_params(tc)) == sds(
        jmodels.abstract_params(jc))
    for batch, max_len in ((4, 96), (32, 4096)):
        assert _spec_leaves(tmodels.cache_specs(tc, batch, max_len)) == \
            _spec_leaves(jmodels.cache_specs(jc, batch, max_len))
        assert meta(tmodels.abstract_cache(tc, batch, max_len)) == sds(
            jmodels.abstract_cache(jc, batch, max_len))


@pytest.mark.parametrize("feedback", [False, True])
def test_opt_and_train_state_specs_equal_jax(feedback):
    for arch in ("tinyllama-1.1b", "deepseek-moe-16b", "whisper-small"):
        jc, tc = j_get_config(arch), t_get_config(arch)
        ps_j, ps_t = jmodels.param_specs(jc), tmodels.param_specs(tc)
        assert _spec_leaves(toptim.opt_state_specs(ps_t)) == _spec_leaves(
            joptim.opt_state_specs(ps_j))
        got = ttrain.train_state_specs(
            tc, CompressionConfig(error_feedback=feedback))
        want = jtrain.train_state_specs(jc, JComp(error_feedback=feedback))
        assert sorted(got) == sorted(want)
        assert _spec_leaves(got) == _spec_leaves(want)
        assert toptim.opt_state_specs(ps_t)["step"] == ()
    assert "ef" not in ttrain.train_state_specs(t_get_config("gemma-2b"))


_MESHES = {"16x16": {"data": 16, "model": 16},
           "2x16x16": {"pod": 2, "data": 16, "model": 16},
           "2x2": {"data": 2, "model": 2}, "2x4": {"data": 2, "model": 4},
           "1x1": {"data": 1, "model": 1}}
_RULES = ("FSDP_RULES", "DP_TP_RULES", "PURE_DP_RULES", "FLEET_RULES")


@pytest.mark.parametrize("mesh", list(_MESHES))
@pytest.mark.parametrize("rules", _RULES)
def test_spec_for_equals_jax_on_every_leaf(mesh, rules):
    """Every parameter leaf of the ten full configs (467 leaves), and the
    caches' and a batch's leaves, resolve to JAX's ``PartitionSpec``."""
    m = SimpleNamespace(shape=_MESHES[mesh])
    jr, tr = getattr(jshd, rules), getattr(tshd, rules)
    n = 0
    for arch in ARCHS:
        tc = t_get_config(arch)
        trees = [(tmodels.param_specs(tc), tmodels.abstract_params(tc)),
                 (tmodels.cache_specs(tc, 32, 4096),
                  tmodels.abstract_cache(tc, 32, 4096))]
        for specs, shapes in trees:
            for spec, x in zip(_spec_leaves(specs), leaves(shapes)):
                want = jshd.spec_for(spec, x.shape, m, jr)
                got = tshd.spec_for(spec, x.shape, m, tr)
                assert got == tuple(want) + (None,) * (x.ndim - len(want)), (
                    arch, spec, x.shape)
                n += 1
    for shape in ((8, 4097), (32, 4097), (512, 129), (3, 7)):
        assert tshd.spec_for(("batch", "seq"), shape, m, tr) == tuple(
            jshd.spec_for(("batch", "seq"), shape, m, jr))
    assert n > 467


def test_placements_follow_the_resolved_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 4, 2))
    got = tshd.placements_for((("pod", "data"), None, "model"), mesh)
    assert got == (Shard(0), Shard(0), Shard(2))
    assert tshd.placements_for((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="dim order"):
        tshd.placements_for((("model", "data"),), mesh)
    one = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    assert tshd.placements_for(("data", "model"), one) == (Replicate(),
                                                            Shard(1))
    assert tshd.strip_rules(tshd.FSDP_RULES, ("pod", "data"))["batch"] is None
    assert tshd.strip_rules(tshd.PURE_DP_RULES, ("data",))["batch"] == (
        "pod", "model")


def test_constrain_outside_a_context_and_named_sharding_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert tshd.constrain(x, "batch", "embed") is x
    assert tshd.current_context() is None
    with pytest.raises(ValueError, match="requires a mesh"):
        tshd.named_sharding(("batch", "embed"), (2, 3))
    with pytest.raises(ValueError, match="requires a mesh"):
        jshd.named_sharding(("batch", "embed"), (2, 3))
    mesh = SimpleNamespace(shape={"data": 2, "model": 1},
                           mesh_dim_names=("data", "model"))
    with tshd.use_sharding(mesh, tshd.DP_TP_RULES) as ctx:
        assert tshd.current_context() is ctx
        assert tshd.spec_for(("batch", "embed"), (4, 6)) == ("data", None)
        assert tshd.constrain(x, "batch", "embed") is x   # a plain tensor
        ns = tshd.named_sharding(("embed", "vocab"), (4, 6))
        assert ns.spec == (None, "model") and ns.mesh is mesh
    assert tshd.current_context() is None
    assert tshd.spec_for(("batch", "embed"), (4, 6)) == (None, None)


# ---------------------------------------------------------------------------
# Four gloo ranks against JAX on four host devices
# ---------------------------------------------------------------------------

_TINY_OVER = dict(dense_attn_max_seq=8, attn_chunk=16, remat="full")
_LOOP_OVER = dict(n_layers=2, block_pattern=("attn",) * 2)
_COMP = dict(topk_ratio=1 / 16, min_size=1024)

_JAX_CODE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding as shd
from repro.core.compression import CompressionConfig, topk_compress
from repro.sharding import make_mesh_compat
from repro.train import (TrainHyper, make_compressed_train_step,
                         make_loss_fn, make_train_step, train_state_specs)

with open(sys.argv[1], "rb") as f:
    b = pickle.load(f)
hyper = TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10)
mesh = make_mesh_compat((2, 2), ("data", "model"))
out = {}


def put(state, cfg, rules, comp=None):
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    sh = shd.tree_named_shardings(train_state_specs(cfg, comp), abstract,
                                  mesh, rules)
    return jax.device_put(jax.tree_util.tree_map(jnp.asarray, state), sh), sh


def run(step, state, batches, rules):
    metrics = []
    with shd.use_sharding(mesh, rules):
        for tok in batches:
            bsh = shd.named_sharding(("batch", "seq"), tok.shape, mesh, rules)
            state, m = step(state, {"tokens": jax.device_put(tok, bsh)})
            metrics.append({k: np.asarray(v) for k, v in m.items()})
    return jax.tree_util.tree_map(np.asarray, state), metrics


cfgs = b["jcfgs"]
fsdp, dptp = shd.FSDP_RULES, shd.DP_TP_RULES
tl = cfgs["tinyllama-1.1b"]
state, sh = put(b["tiny"], tl, fsdp)
out["shard_shapes"] = {
    jax.tree_util.keystr(p): tuple(s.shard_shape(x.shape))
    for (p, x), s in zip(jax.tree_util.tree_flatten_with_path(b["tiny"])[0],
                         jax.tree_util.tree_leaves(sh))}
with shd.use_sharding(mesh, fsdp):
    out["fsdp"] = run(jax.jit(make_train_step(tl, hyper)), state,
                      b["tiny_batches"], fsdp)

comp = CompressionConfig(**b["comp"])
state, _ = put(b["tiny_ef"], tl, dptp, comp)
with shd.use_sharding(mesh, dptp):
    step = jax.jit(make_compressed_train_step(tl, hyper, comp, mesh,
                                              ("data",)))
    out["dptp"] = run(step, state, b["tiny_batches"], dptp)
grad_fn = jax.jit(jax.value_and_grad(make_loss_fn(tl), has_aux=True))
tok = b["tiny_batches"][0]
picked = []
for r in range(2):
    _, g = grad_fn(b["tiny"]["params"], {"tokens": tok[2 * r:2 * r + 2]})
    picked.append([np.asarray(topk_compress(
        leaf.reshape(-1).astype(jnp.float32), max(1, int(leaf.size
                                                         * comp.topk_ratio)))[1])
        for leaf in jax.tree_util.tree_leaves(g)
        if leaf.size >= comp.min_size])
out["dptp_topk"] = picked

for name, rules in (("deepseek-moe-16b", fsdp),
                    ("recurrentgemma-2b", fsdp),
                    ("mamba2-130m", shd.PURE_DP_RULES)):
    state, _ = put(b[name], cfgs[name], rules)
    with shd.use_sharding(mesh, rules):
        out[name] = run(jax.jit(make_train_step(cfgs[name], hyper)), state,
                        b[name + "/batch"], rules)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _state(cfg, ef=False):
    """JAX's state of ``cfg`` as numpy: numpy-drawn params, AdamW's zero
    state, zero residuals with ``ef``."""
    jp, _ = _params(cfg)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    st = {"params": jp, "opt": jax.tree_util.tree_map(
        np.asarray, joptim.adamw_init(jp, joptim.OptConfig()))}
    if ef:
        st["ef"] = jax.tree_util.tree_map(np.zeros_like, jp)
    return st


def _spawn(args, env: dict, log: Path) -> subprocess.Popen:
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, *args],
                                env=dict(os.environ, **env), stdout=f,
                                stderr=subprocess.STDOUT)


def _plain_steps(cfg, state_np, batches):
    """The port's unsharded steps on one thread, and the grads of the
    last batch at the last state."""
    hyper = ttrain.TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10)
    step, st, metrics = ttrain.make_train_step(cfg, hyper), train_state(
        state_np), []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i, tok in enumerate(batches):
            if i == len(batches) - 1:
                _, _, grads = ttrain.value_and_grad(
                    ttrain.make_loss_fn(cfg), st["params"],
                    {"tokens": torch.as_tensor(tok)})
            st, m = step(st, {"tokens": torch.as_tensor(tok)})
            metrics.append(m)
    finally:
        torch.set_num_threads(threads)
    return st, metrics, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's subprocess, the four ranks and the one rank run in the
    background while this process runs the unsharded steps; every process
    is waited for (or killed) before the fixture returns."""
    tmp = tmp_path_factory.mktemp("lm_sharding")
    tl = dataclasses.replace(_smoke("tinyllama-1.1b"), **_TINY_OVER)
    cfgs = {"tinyllama-1.1b": tl,
            "deepseek-moe-16b": _smoke("deepseek-moe-16b"),
            "recurrentgemma-2b": _smoke("recurrentgemma-2b"),
            "mamba2-130m": _smoke("mamba2-130m")}
    loop_cfg = dataclasses.replace(_smoke("tinyllama-1.1b"), **_LOOP_OVER)
    b = {"tiny": _state(tl), "tiny_ef": _state(tl, ef=True),
         "tiny_batches": [_tokens(tl, 4, 33, seed) for seed in (0, 1)],
         "tiny_over": _TINY_OVER, "loop_over": _LOOP_OVER, "comp": _COMP,
         "ckpt": str(tmp / "jax_ckpt"), "tmp": str(tmp),
         "loop_batches": [lm_batches(LMTask(vocab=loop_cfg.vocab, seq_len=16,
                                            batch=4), s,
                                     device="cpu")["tokens"].numpy()
                          for s in range(6)]}
    for name in ("deepseek-moe-16b", "recurrentgemma-2b", "mamba2-130m"):
        b[name] = _state(cfgs[name])
        b[name + "/batch"] = [_tokens(cfgs[name], 4, 33, 2)]
    for name in ("tinyllama-1.1b", "recurrentgemma-2b", "mamba2-130m"):
        b[name + "/prompt"] = _tokens(cfgs[name], 4, 16, 3)
        b[name + "/decode"] = _tokens(cfgs[name], 4, 2, 4)
    jckpt.save_checkpoint(b["ckpt"], 3, jax.tree_util.tree_map(
        jnp.asarray, b["tiny"]))
    with open(tmp / "bundle.pkl", "wb") as f:
        pickle.dump(b, f)
    with open(tmp / "jax_bundle.pkl", "wb") as f:
        pickle.dump(dict(b, jcfgs={k: _jcfg(v) for k, v in cfgs.items()}), f)
    src = dict(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    logs = [tmp / "jax.log"] + [tmp / f"rank{r}.log" for r in range(4)] + [
        tmp / "one.log"]
    procs = [_spawn(["-c", textwrap.dedent(_JAX_CODE),
                     str(tmp / "jax_bundle.pkl"), str(tmp / "jax.pkl")],
                    dict(src, JAX_PLATFORMS="cpu",
                         XLA_FLAGS="--xla_force_host_platform_device_count=4"),
                    logs[0])]
    worker = str(TESTS / "_torch_lm_sharding_worker.py")
    try:
        procs += [_spawn([worker, str(r), "4", str(tmp / "store4"),
                          str(tmp / "bundle.pkl"), str(tmp / f"rank{r}.pt")],
                         src, logs[1 + r]) for r in range(4)]
        procs.append(_spawn([worker, "0", "1", str(tmp / "store1"),
                             str(tmp / "bundle.pkl"), str(tmp / "one.pt")],
                            src, logs[5]))
        plain = _plain_steps(tl, b["tiny"], b["tiny_batches"])
        for p in procs:
            p.wait(timeout=400)
        failed = [log.read_text()[-3000:] for p, log in zip(procs, logs)
                  if p.returncode]
        assert not failed, "\n".join(failed)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(tmp / "jax.pkl", "rb") as f:
        jax_res = pickle.load(f)
    return dict(
        bundle=b, plain=plain, jax=jax_res,
        ranks=[torch.load(tmp / f"rank{r}.pt", weights_only=False)
               for r in range(4)],
        one=torch.load(tmp / "one.pt", weights_only=False))


def _keyed(tree_np) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree_np)[0]}


def _keyed_port(tree) -> dict:
    from repro_torch.convert import to_numpy
    return {"".join(f"[{k!r}]" for k in p): to_numpy(v)
            for p, v in leaves_with_paths(tree)}


def test_fsdp_steps_match_jax_and_the_unsharded_step(runs):
    """Two FSDP steps of the tinyllama smoke config (flash walks under
    remat) on (2, 2): loss, grad norm and lr within 1e-5 of JAX's jitted
    FSDP step and of the port's unsharded step, on every rank; moments
    within 1e-5; params where the unsharded step-1 |g| exceeds 1e-4 or is
    0 (AdamW's first moving step takes lr * sign(g), which a gradient
    within rounding of zero can flip; the excluded count is printed)."""
    jstate, jm = runs["jax"]["fsdp"]
    plain, pm, g1 = runs["plain"]
    want, ref = _keyed(jstate), _keyed_port(plain)
    g1 = _keyed_port(g1)
    excluded = 0
    for rank in runs["ranks"]:
        for i in range(2):
            for k in ("loss", "grad_norm", "lr"):
                _close(rank["fsdp_metrics"][i][k], jm[i][k])
                _close(rank["fsdp_metrics"][i][k], pm[i][k])
        got = rank["fsdp_state"]
        assert sorted(got) == sorted(want)
        for name, val in got.items():
            for other in (want[name], ref[name]):
                if name.startswith("['params']"):
                    g = g1[name.replace("['params']", "", 1)]
                    clear = (np.abs(g) > 1e-4) | (g == 0)
                    excluded += int((~clear).sum())
                    _close(val[clear], other[clear])
                else:
                    _close(val, other, rtol=1e-5, atol=1e-7)
    print(f"params held where |g| > 1e-4 or g == 0; excluded {excluded}")


def test_local_shards_have_jax_shard_shapes(runs):
    """Every rank's local shard of every state leaf, placed by
    ``train_state_specs`` under FSDP, has the shape of JAX's
    ``NamedSharding(mesh, spec).shard_shape``, and the four ranks' shards
    tile each leaf (the embed table split on both dims, the unembed's
    embed dim over "data" and vocab over "model")."""
    want = runs["jax"]["shard_shapes"]
    for rank in runs["ranks"]:
        got = rank["fsdp_layout"]
        assert sorted(got) == sorted(want)
        for name, (shape, _offset) in got.items():
            assert shape == tuple(want[name]), name
    for name in want:
        offsets = {r["fsdp_layout"][name][1] for r in runs["ranks"]}
        full = _keyed(runs["bundle"]["tiny"])[name].shape
        pieces = np.prod([f // s for f, s in zip(full, want[name])]) if \
            full else 1
        assert len(offsets) == pieces, name
    tiny = runs["ranks"][0]["fsdp_layout"]
    assert tiny["['params']['embed']"][0] == (256, 32)
    assert tiny["['params']['unembed']"][0] == (32, 256)


def test_dp_tp_compressed_steps_match_jax(runs):
    """Two DP+TP coreset-compressed steps (``dp_axes=("data",)``, TP over
    "model"): the codec's top-k index set of every leaf at step 0 on each
    data-parallel rank equals JAX's on the same rows, exactly (two entries
    of equal magnitude to within rounding may come in either order: the
    decompressed sum does not depend on it); loss within 1e-5 and grad
    norm within 1e-4 relative of JAX's; the two model ranks of a
    data-parallel rank and the two data-parallel ranks hold the same
    parameters and moments, within 1e-5 of JAX's but for the bf16 wire
    rounding flips ``_close_but_bf16_flips`` bounds."""
    jstate, jm = runs["jax"]["dptp"]
    want = _keyed(jstate)
    n_big = len(runs["jax"]["dptp_topk"][0])
    assert n_big >= 5
    for r, rank in enumerate(runs["ranks"]):
        picked = rank["dptp_topk"][:n_big]
        for got, exp in zip(picked, runs["jax"]["dptp_topk"][r // 2]):
            np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(exp))
        for i in range(2):
            _close(rank["dptp_metrics"][i]["loss"], jm[i]["loss"])
            _close(rank["dptp_metrics"][i]["grad_norm"], jm[i]["grad_norm"],
                   rtol=1e-4, atol=1e-5)
        flips = 0
        for name, val in rank["dptp_state"].items():
            if name.startswith("['ef']"):
                continue            # each data-parallel rank's own residual
            np.testing.assert_array_equal(
                val, runs["ranks"][0]["dptp_state"][name])
            flips += _close_but_bf16_flips(val, want[name], name)
        print(f"rank {r}: elements beyond 1e-5 of JAX's, each within a "
              f"bf16 step: {flips}")


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "recurrentgemma-2b",
                                  "mamba2-130m"])
def test_moe_fsdp_and_ssd_pure_dp_steps_match_jax(runs, name):
    """One step of the deepseek smoke config under FSDP (its 8 experts on
    "model"), of the recurrentgemma one under FSDP (one KV head, so its
    q heads split within the group and the K/V gradients are summed over
    "model"; the RG-LRU scan) and of the mamba2 one under pure DP (the
    batch over both mesh dims): loss and grad norm within 1e-5 of JAX's
    sharded step; the first moments (0.1 times the clipped grads) within
    1e-5; the params (lr 0 at step 0) unchanged."""
    jstate, jm = runs["jax"][name]
    want = _keyed(jstate)
    for rank in runs["ranks"]:
        got = rank[name]
        for k in ("loss", "grad_norm"):
            _close(got["metrics"][0][k], jm[0][k])
        for key, val in got["state"].items():
            _close(val, want[key], rtol=1e-5, atol=1e-7)


def test_jax_checkpoint_restores_onto_the_mesh(runs):
    """JAX's checkpoint of the tinyllama state restored with
    ``shardings=``: each rank's local shard equals its slice of JAX's
    array, bit for bit, at JAX's shard shapes."""
    want = _keyed(runs["bundle"]["tiny"])
    for rank in runs["ranks"]:
        for name, local in rank["restored"].items():
            shape, offset = rank["restored_layout"][name]
            assert shape == tuple(runs["jax"]["shard_shapes"][name])
            sl = tuple(slice(o, o + n) for o, n in zip(offset, shape))
            np.testing.assert_array_equal(local.numpy(), want[name][sl])


def test_state_drawn_onto_the_mesh_and_saved_whole(runs):
    """``init_train_state(shardings=)``, which places each parameter as it
    is drawn, gives every rank the shards and placements of the placed
    unsharded draw; its checkpoint, written by rank 0 from the shards the
    other ranks send it, restores to the unsharded draw bit for bit."""
    for rank in runs["ranks"]:
        assert rank["drawn"] and all(rank["drawn"].values()), rank["drawn"]
        assert rank["saved"] and all(rank["saved"].values()), rank["saved"]


def test_preempted_sharded_run_is_bitwise_a_clean_one(runs):
    """A sharded run of the loop preempted at step 5 resumes from the
    step-4 checkpoint onto the mesh and ends bit for bit where a clean run
    ends, on every rank; the checkpoints are written by rank 0."""
    for rank in runs["ranks"]:
        crash, clean = rank["loop"]["preempted"], rank["loop"]["clean"]
        events = [m.get("event") for m in crash["log"] if "event" in m]
        assert events == ["preempted", "resume"]
        assert [m["step"] for m in crash["log"]
                if m.get("event") == "resume"] == [4]
        for key, val in crash["state"].items():
            np.testing.assert_array_equal(val, clean["state"][key])
        assert int(crash["state"]["['opt']['step']"]) == 6
        assert all(np.isfinite(m["loss"]) for m in clean["log"]
                   if "loss" in m)
        np.testing.assert_array_equal(
            clean["state"]["['params']['embed']"],
            runs["ranks"][0]["loop"]["clean"]["state"]["['params']['embed']"])


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-2b",
                                  "mamba2-130m"])
def test_decode_on_the_mesh_equals_the_unsharded_decode(runs, name):
    """Two decode steps on 4 gloo ranks from a prefill's cache placed by
    ``cache_specs``: tinyllama's and recurrentgemma's attention caches
    split on the sequence over "model" (split-KV: their KV heads do not
    divide the axis), their softmax met in all-reduces; mamba2's state by
    batch rows.  The logits equal the plain decode's within 1e-5 on every
    rank (the split softmax sums in another order)."""
    for rank in runs["ranks"]:
        got = rank["decode"][name]
        assert got["err"] <= 1e-5, (name, got["err"])
        for a, b in zip(got["logits"], runs["ranks"][0]["decode"][name][
                "logits"]):
            np.testing.assert_array_equal(a, b)
    split = runs["ranks"][0]["decode"][name]["placements"]
    if name != "mamba2-130m":
        # the (L, B, W, G, Dh) cache: batch over "data", W over "model"
        assert all(p == ["S(1)", "S(2)"] for k, p in split.items()
                   if k.endswith("['k']")), split


@pytest.mark.parametrize("step", ["fsdp", "fsdp_micro", "dptp"])
def test_world_of_one_equals_the_unsharded_step(runs, step):
    """On a (1, 1) mesh the FSDP step (also with microbatches of 2)
    equals the unsharded step, and the DP+TP compressed step the
    process-group step with no group, bit for bit: metrics and every
    state leaf."""
    (got, gm), (want, wm) = runs["one"][step]["mesh"], runs["one"][step][
        "plain"]
    assert sorted(got) == sorted(want)
    for i in range(2):
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(gm[i][k], wm[i][k]), (i, k)
    for key, val in got.items():
        np.testing.assert_array_equal(val, want[key], err_msg=key)


def test_the_sharding_modules_leave_jax_out():
    """``repro_torch.sharding`` and ``repro_torch.launch.mesh`` (which
    ``tests/test_torch_fleet.py``'s import scan reads too) import neither
    JAX nor the JAX package, and ``make_mesh_for`` refuses to run without
    a process group."""
    code = ("import sys; import repro_torch.sharding, "
            "repro_torch.launch.mesh as m; "
            "exec('try:\\n m.make_mesh_for((1,), (\"data\",))\\n"
            "except RuntimeError as e:\\n print(\"refused\" if \"process "
            "group\" in str(e) else e)'); "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.split()[-3:] == ["refused", "False", "False"]
