"""The MoE, RG-LRU and SSD serving paths in ``repro_torch`` against
``repro``, on the same numpy inputs, on the CPU: ``moe_apply`` (drops and
routing ties included), the RG-LRU and SSD blocks and their decode steps,
``forward``, prefill-then-decode (logits, ``pos`` and every cache leaf) and
``generate`` for the deepseek-moe-16b, grok-1-314b, recurrentgemma-2b and
mamba2-130m smoke configs and ``tests/test_models.py``'s rglru, ssd and
moe kinds, the bfloat16 forward, ``compute_params``' float32 leaves, the
init laws, the group and chunk rules and the serve launcher.

Parameters in the layout of JAX's ``init_params``, drawn with numpy,
reach JAX as arrays and the port through ``convert.lm_params``.  Float
tolerances are float32's: rtol 1e-5, atol 1e-5, unless a test says
otherwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params, to_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import ssd as tssd  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models.layers import geglu, swiglu  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

# JAX's functions jitted: one compile a shape, not one a primitive
_j_decode_step = jax.jit(j_decode_step, static_argnums=1)
_j_forward = jax.jit(j_forward, static_argnums=1,
                     static_argnames=("return_cache", "cache_len"))
_j_rglru_apply = jax.jit(jrglru.rglru_apply, static_argnames="return_state")
_j_rglru_step = jax.jit(jrglru.rglru_decode_step)
_j_ssd_apply = jax.jit(jssd.ssd_apply, static_argnums=2,
                       static_argnames=("chunk", "return_state"))
_j_ssd_step = jax.jit(jssd.ssd_decode_step, static_argnums=3)
_j_moe_apply = jax.jit(jmoe.moe_apply, static_argnums=(2, 3))
_j_generate = jax.jit(jengine.generate, static_argnums=(1, 3),
                      static_argnames="temperature")
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("deepseek-moe-16b", "grok-1-314b", "recurrentgemma-2b",
         "mamba2-130m")
# tests/test_models.py's KINDS, in the port's config
_BASE = dict(vocab=128, d_model=32, n_layers=3, n_heads=4, n_kv=2, d_ff=64,
             dtype=torch.float32)
KINDS = {
    "kind-rglru": ModelConfig(name="r", **_BASE, rnn_width=32,
                              block_pattern=("rglru", "rglru", "local"),
                              window=4),
    "kind-ssd": ModelConfig(name="s", **{**_BASE, "d_ff": 0}, mlp="none",
                            block_pattern=("ssd",) * 3, ssm_state=8,
                            ssm_headdim=8),
    "kind-moe": ModelConfig(name="m", **_BASE, moe_layers=(1, 2),
                            moe=MoEConfig(n_experts=4, top_k=2, d_expert=16,
                                          capacity_factor=2.0)),
}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _cfg(name):
    if name in KINDS:
        return KINDS[name]
    if name == "deepseek-drop":
        # capacity factor 0.5: the prefill drops tokens too
        cfg = tconfigs.get_smoke("deepseek-moe-16b")
        return dataclasses.replace(cfg, name="deepseek-drop", moe=dataclasses.
                                   replace(cfg.moe, capacity_factor=0.5))
    return tconfigs.get_smoke(name)


def _jcfg(cfg):
    """The JAX twin of a port config (the same fields, JAX dtypes)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = jnp.dtype(str(cfg.dtype).split(".")[1])
    fields["param_dtype"] = jnp.dtype(str(cfg.param_dtype).split(".")[1])
    if cfg.moe is not None:
        fields["moe"] = JMoEConfig(**dataclasses.asdict(cfg.moe))
    return JModelConfig(**fields)


def _draw(rng, name: str, shape, stacked: bool) -> np.ndarray:
    """One leaf: the recurrent mixers' non-weight leaves by the reference's
    laws (so decays span the realistic range), norm scales 0.1 x normal,
    ``D`` 1 + 0.1 x normal, the rest normal / sqrt(fan_in)."""
    if name == "lam":
        a = rng.uniform(0.9, 0.999, shape) ** 2
        return np.log(np.expm1(-np.log(a) / 8.0)).astype(np.float32)
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if name == "dt_bias":
        u = rng.uniform(1e-3, 1e-1, shape)
        return (u + np.log(-np.expm1(-u))).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    if "norm" in name:
        return 0.1 * x
    if name == "D":
        return 1 + 0.1 * x
    return x / np.sqrt(np.prod(shape[int(stacked):-1]))


_PARAMS = {}


def _params(cfg):
    """A parameter tree of JAX's ``init_params`` layout for ``cfg``, drawn
    with numpy, as JAX arrays and the port's copy (``convert.lm_params``)."""
    if cfg.name not in _PARAMS:
        rng = np.random.default_rng(len(_PARAMS))
        tree = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                    _jcfg(cfg)))
        jp = jax.tree_util.tree_map_with_path(
            lambda path, leaf: _draw(rng, path[-1].key, leaf.shape,
                                     path[0].key == "runs"), tree)
        _PARAMS[cfg.name] = (jax.tree_util.tree_map(jnp.asarray, jp),
                             lm_params(jp))
    return _PARAMS[cfg.name]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _leaves(shapes: dict, rng, stacked=False) -> dict:
    return {k: _draw(rng, k, v, stacked) for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    # (MoEConfig, gate activation); capacity factor 0.5 drops tokens
    "swiglu_shared": (MoEConfig(n_experts=8, top_k=2, d_expert=16,
                                n_shared=2, capacity_factor=2.0,
                                group_size=16), "swiglu"),
    "geglu": (MoEConfig(n_experts=4, top_k=2, d_expert=16,
                        group_size=16), "geglu"),
    "swiglu_shared_drop": (MoEConfig(n_experts=8, top_k=3, d_expert=16,
                                     n_shared=2, capacity_factor=0.5,
                                     group_size=16), "swiglu"),
    "geglu_drop": (MoEConfig(n_experts=4, top_k=2, d_expert=16,
                             capacity_factor=0.5, group_size=16), "geglu"),
}


@functools.partial(jax.jit, static_argnums=2)
def _jax_route(params, x, m):
    """The reference's routing lines (``moe.py:59-70``), for its experts
    and its kept set."""
    b, s, d = x.shape
    group = min(m.group_size, b * s)
    g = b * s // group
    logits = jnp.einsum("gsd,de->gse", x.reshape(g, group, d),
                        params["router"])
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(top_e, m.n_experts, dtype=jnp.float32)
    flat = onehot.reshape(g, group * m.top_k, m.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    pos = jnp.sum(pos * onehot, axis=-1)
    return top_e, pos < jmoe.moe_capacity(m, group)


def _moe_case(m, act, seed, x_scale=1.0, router=None):
    rng = np.random.default_rng(seed)
    p = _leaves({k: v[0] for k, v in tmoe.moe_param_shapes(32, m).items()},
                rng)
    if router is not None:
        p["router"] = router
    x = (x_scale * rng.standard_normal((2, 24, 32))).astype(np.float32)
    jm = JMoEConfig(**dataclasses.asdict(m))
    want = _j_moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jm, getattr(jl, act))
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    got = tmoe.moe_apply(tp, torch.as_tensor(x), m,
                         {"swiglu": swiglu, "geglu": geglu}[act])
    route = tmoe.moe_route(tp["router"], torch.as_tensor(x).reshape(
        -1, min(m.group_size, 48), 32), m)
    return got, want, route, tuple(map(np.asarray, _jax_route(p, x, jm)))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """Three groups of 16 tokens; with a capacity factor of 0.5 the
    reference drops assignments, and the port keeps and drops the same
    ones (the queue order is token-major, k inner)."""
    m, act = MOE_CASES[case]
    got, want, route, (j_top_e, j_keep) = _moe_case(m, act, seed=7)
    _close(got, want)
    np.testing.assert_array_equal(route.top_e.numpy(), j_top_e)
    np.testing.assert_array_equal(route.keep.numpy(), j_keep)
    assert route.top_p.dtype == torch.float32
    if case.endswith("_drop"):
        assert (~j_keep).sum() >= 1
        assert m.top_k * 16 > tmoe.moe_capacity(m, 16) * m.n_experts
    else:
        assert j_keep.all()


def test_moe_routing_ties_take_the_lowest_index():
    """Tied router probabilities: a zero router ties every expert, and
    duplicated router columns tie pairs of experts; the lowest index comes
    first, as in ``jax.lax.top_k``, and the outputs agree."""
    m = MoEConfig(n_experts=6, top_k=2, d_expert=16, capacity_factor=0.5,
                  group_size=16)
    got, want, route, (j_top_e, j_keep) = _moe_case(
        m, "swiglu", seed=8, router=np.zeros((32, 6), np.float32))
    assert (route.top_e.numpy() == np.array([0, 1])).all()
    np.testing.assert_array_equal(route.top_e.numpy(), j_top_e)
    np.testing.assert_array_equal(route.keep.numpy(), j_keep)
    _close(got, want)
    rng = np.random.default_rng(9)
    router = (rng.standard_normal((32, 6)) / np.sqrt(32)).astype(np.float32)
    router[:, 4], router[:, 5] = router[:, 1], router[:, 0]
    got, want, route, (j_top_e, j_keep) = _moe_case(m, "swiglu", seed=8,
                                                    router=router)
    np.testing.assert_array_equal(route.top_e.numpy(), j_top_e)
    np.testing.assert_array_equal(route.keep.numpy(), j_keep)
    for twin, first in ((4, 1), (5, 0)):
        # a twin is picked only beside its lower-index original, after it
        rows = (j_top_e == twin).any(-1)
        assert rows.any()
        assert (j_top_e[rows][:, 0] == first).all()
    _close(got, want)


# ---------------------------------------------------------------------------
# RG-LRU and SSD blocks
# ---------------------------------------------------------------------------

RG_CFG = ModelConfig(name="rg", vocab=64, d_model=32, n_layers=1, n_heads=2,
                     n_kv=1, d_ff=64, rnn_width=24, conv_width=4,
                     block_pattern=("rglru",), dtype=torch.float32)
SSD_CFG = ModelConfig(name="ssd", vocab=64, d_model=32, n_layers=1,
                      n_heads=0, n_kv=0, head_dim=1, d_ff=0, mlp="none",
                      block_pattern=("ssd",), ssm_state=8, ssm_headdim=16,
                      ssm_groups=2, dtype=torch.float32)


def _cache_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        _close(got[name], want[name])


def _block(kind, s, seed):
    rng = np.random.default_rng(seed)
    cfg = RG_CFG if kind == "rglru" else SSD_CFG
    shapes = (trglru.rglru_param_shapes(cfg) if kind == "rglru"
              else tssd.ssd_param_shapes(cfg))
    p = _leaves({k: v[0] for k, v in shapes.items()}, rng)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    return (cfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()}, x)


@pytest.mark.parametrize("s", [13, 16, 2])
def test_rglru_apply_and_decode_match_jax(s):
    """The full-sequence block (odd and even lengths through the log-depth
    scan), its prefill state (a 2-token prompt left-pads the conv ring),
    and 4 decode steps from that state: outputs and states."""
    _, jp, tp, x = _block("rglru", s, seed=s)
    _close(trglru.rglru_apply(tp, torch.as_tensor(x)),
           _j_rglru_apply(jp, jnp.asarray(x)))
    jout, jstate = _j_rglru_apply(jp, jnp.asarray(x), return_state=True)
    tout, tstate = trglru.rglru_apply(tp, torch.as_tensor(x),
                                      return_state=True)
    _close(tout, jout)
    _cache_close(to_numpy(tstate), jstate)
    steps = np.random.default_rng(1).standard_normal((4, 2, 1, 32)).astype(
        np.float32)
    for xt in steps:
        jout, jstate = _j_rglru_step(jp, jstate, jnp.asarray(xt))
        tout, tstate = trglru.rglru_decode_step(tp, tstate,
                                                torch.as_tensor(xt))
        _close(tout, jout)
        _cache_close(to_numpy(tstate), jstate)


def test_associative_scan_is_the_recurrence():
    """The log-depth scan equals the sequential recurrence h_t = a_t h_{t-1}
    + b_t at every length up to 40 (float32, rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 40, 3)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((2, 40, 3)).astype(np.float32))
    for n in range(1, 41):
        h, want = torch.zeros(2, 3), []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(trglru.associative_scan(a[:, :n], b[:, :n])[1],
               torch.stack(want, dim=1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,chunk", [(16, 128), (32, 8), (24, 8), (2, 128)])
def test_ssd_apply_and_decode_match_jax(s, chunk):
    """One chunk, several chunks (4 and 3), and a 2-token prompt (the conv
    ring left-padded); the prefill state and 4 decode steps from it."""
    cfg, jp, tp, x = _block("ssd", s, seed=s + chunk)
    jcfg = _jcfg(cfg)
    jout, jstate = _j_ssd_apply(jp, jnp.asarray(x), jcfg, chunk=chunk,
                                  return_state=True)
    tout, tstate = tssd.ssd_apply(tp, torch.as_tensor(x), cfg, chunk=chunk,
                                  return_state=True)
    _close(tout, jout)
    _cache_close(to_numpy(tstate), jstate)
    _close(tssd.ssd_apply(tp, torch.as_tensor(x), cfg, chunk=chunk), jout)
    steps = np.random.default_rng(3).standard_normal((4, 2, 1, 32)).astype(
        np.float32)
    for xt in steps:
        jout, jstate = _j_ssd_step(jp, jstate, jnp.asarray(xt), jcfg)
        tout, tstate = tssd.ssd_decode_step(tp, tstate, torch.as_tensor(xt),
                                            cfg)
        _close(tout, jout)
        _cache_close(to_numpy(tstate), jstate)


def test_segsum_masks_before_the_exp():
    x = torch.tensor([[0.5, -1.0, 2.0, -0.25]])
    seg = tssd._segsum(x)
    want = np.asarray(jssd._segsum(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(seg.numpy(), want)
    assert torch.isfinite(torch.exp(seg)).all()
    assert (torch.exp(seg).triu(1) == 0).all()


# ---------------------------------------------------------------------------
# forward, prefill and decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ARCHS) + ["deepseek-drop"]
                         + list(KINDS))
def test_forward_matches_jax(name):
    cfg = _cfg(name)
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 2, 16)
    want = np.asarray(_j_forward(jp, _jcfg(cfg), jnp.asarray(toks)))
    _close(tt.forward(tp, cfg, torch.as_tensor(toks)), want)


@pytest.mark.parametrize("name", list(ARCHS) + list(KINDS))
def test_prefill_then_decode_matches_jax(name):
    """Prefill 12 tokens into a cache of 18, then decode 5: logits, ``pos``
    and every cache leaf (k/v, RG-LRU h and conv ring, SSD state and conv
    ring) equal JAX's after the prefill and after each step.  The decode
    groups of the MoE configs hold the batch (capacity 1: assignments
    drop); recurrentgemma's smoke window of 8 is under the prompt."""
    cfg = _cfg(name)
    jcfg = _jcfg(cfg)
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 2, 17, seed=1)

    def equal(tlg, tcache, jlg, jcache):
        _close(tlg, jlg)
        got = to_numpy(tcache)
        assert int(got["pos"]) == int(jcache["pos"])
        assert len(got["runs"]) == len(jcache["runs"])
        for a, b in zip(got["runs"], jcache["runs"]):
            _cache_close(a, b)

    jlg, jcache = _j_forward(jp, jcfg, jnp.asarray(toks[:, :12]),
                            return_cache=True, cache_len=18)
    tlg, tcache = tt.forward(tp, cfg, torch.as_tensor(toks[:, :12]),
                             return_cache=True, cache_len=18)
    equal(tlg, tcache, jlg, jcache)
    for t in range(12, 17):
        jlg, jcache = _j_decode_step(jp, jcfg, jcache,
                                     jnp.asarray(toks[:, t:t + 1]))
        tlg, tcache = tt.decode_step(tp, cfg, tcache,
                                     torch.as_tensor(toks[:, t:t + 1]))
        equal(tlg, tcache, jlg, jcache)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_jax(name):
    """Greedy tokens equal JAX's wherever JAX's top-1/top-2 margin of the
    step's logits (its own decode replay) exceeds 1e-4; a row stops being
    compared after a token within the margin.  With JAX's Gumbel draws
    injected (step 0 from the key, step t from ``split(key, max_new -
    1)[t - 1]``), temperature sampling gives JAX's tokens."""
    cfg = _cfg(name)
    jcfg = _jcfg(cfg)
    jp, tp = _params(cfg)
    prompt = _tokens(cfg, 2, 12, seed=2)
    want = np.asarray(_j_generate(jp, jcfg, jnp.asarray(prompt), 6))
    got = engine.generate(tp, cfg, prompt, 6, device="cpu").numpy()
    assert got.dtype == np.int32 and got.shape == (2, 6)
    lg, cache = _j_forward(jp, jcfg, jnp.asarray(prompt), return_cache=True,
                           cache_len=18)
    steps = [lg[:, -1]]
    for t in range(5):
        lg, cache = _j_decode_step(jp, jcfg, cache,
                                   jnp.asarray(want[:, t:t + 1]))
        steps.append(lg[:, 0])
    top2 = np.sort(np.stack([np.asarray(x) for x in steps], 1), -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    for b in range(2):
        for t in range(6):
            if not clear[b, t]:
                break
            assert got[b, t] == want[b, t], (b, t)
    assert clear[:, 0].all()

    key, temp = jax.random.PRNGKey(4), 0.8
    keys = [key] + list(jax.random.split(key, 5))
    gumbel = np.stack([np.asarray(jax.random.gumbel(
        k, (2, cfg.padded_vocab), jnp.float32)) for k in keys])
    want = np.asarray(_j_generate(jp, jcfg, jnp.asarray(prompt), 6,
                                       key=key, temperature=temp))
    got = engine.generate(tp, cfg, prompt, 6, temperature=temp,
                          gumbel=torch.as_tensor(gumbel), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ARCHS)
def test_bfloat16_forward_tracks_jax(name):
    """In bfloat16, weights cast once by ``compute_params`` give bit for bit
    the logits of a cast at each use, as the reference casts; and the
    logits stay within the bfloat16 tolerance of JAX's: RMS difference at
    most 0.05 and largest at most 0.25 of the logits' standard deviation,
    the bounds of the attention decoders' test."""
    cfg = dataclasses.replace(_cfg(name), dtype=torch.bfloat16)
    jp, tp = _params(_cfg(name))
    toks = _tokens(cfg, 2, 16)
    got = tt.forward(tt.compute_params(tp, cfg), cfg, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tt.forward(tp, cfg, torch.as_tensor(toks)))
    want = np.asarray(_j_forward(jp, _jcfg(cfg), jnp.asarray(toks)),
                      np.float32)[..., :cfg.vocab]
    diff = got.float().numpy()[..., :cfg.vocab] - want
    assert np.sqrt(np.mean(diff ** 2)) <= 0.05 * want.std()
    assert np.abs(diff).max() <= 0.25 * want.std()


# ---------------------------------------------------------------------------
# Parameters, rules, launcher
# ---------------------------------------------------------------------------

def test_compute_params_keeps_the_float32_leaves():
    """``lam``, ``A_log``, ``dt_bias`` and the norm scales stay bit-equal
    float32 (the reference reads them in float32); every other leaf is
    cast to bfloat16."""
    for name in ("recurrentgemma-2b", "mamba2-130m", "deepseek-moe-16b"):
        cfg = dataclasses.replace(_cfg(name), dtype=torch.bfloat16)
        _, tp = _params(_cfg(name))
        cp = tt.compute_params(tp, cfg)
        kept = set()
        for run, crun in zip(tp["runs"], cp["runs"]):
            for k, v in run.items():
                if "norm" in k or k in ("lam", "A_log", "dt_bias"):
                    assert crun[k].dtype == torch.float32, k
                    assert torch.equal(crun[k], v), k
                    kept.add(k)
                else:
                    assert crun[k].dtype == torch.bfloat16, k
        assert cp["final_norm"].dtype == torch.float32
        assert cp["embed"].dtype == torch.bfloat16
        want = {"recurrentgemma-2b": {"norm1", "norm2", "lam"},
                "mamba2-130m": {"norm1", "norm_scale", "A_log", "dt_bias"},
                "deepseek-moe-16b": {"norm1", "norm2"}}[name]
        assert kept == want, kept


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_tree_and_laws(name):
    """The port's random parameters have JAX's tree, shapes and dtypes,
    and the reference's laws: normal / sqrt(fan_in) weights (an MoE leaf's
    fan-in counts its experts), zero norm scales, ``D`` all ones,
    ``exp(A_log)`` in [1, 16], ``softplus(dt_bias)`` in [1e-3, 0.1] and
    RG-LRU's ``exp(-8 softplus(lam))`` in [0.9^2, 0.999^2]."""
    cfg = _cfg(name)
    tp = tt.init_params(torch.Generator().manual_seed(0), cfg)
    jp = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                              _jcfg(cfg)))
    flat_t = jax.tree_util.tree_leaves_with_path(to_numpy(tp))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        leaf, stacked = path[-1].key, path[0].key == "runs"
        if "norm" in leaf:
            assert not a.any(), path
        elif leaf == "D":
            assert (a == 1).all()
        elif leaf == "A_log":
            assert (np.exp(a) >= 1 - 1e-6).all() and (np.exp(a) <= 16).all()
        elif leaf == "dt_bias":
            dt = np.logaddexp(a, 0)
            assert (dt >= 1e-3 - 1e-7).all() and (dt <= 0.1 + 1e-7).all()
        elif leaf == "lam":
            a_t = np.exp(-8 * np.logaddexp(a, 0))
            assert (a_t >= 0.81 - 1e-5).all() and (a_t <= 0.998 + 1e-5).all()
        else:
            shape = a.shape[int(stacked):]
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
            # four standard errors of a std estimated from a.size samples
            tol = max(0.1, 4 / np.sqrt(2 * a.size))
            assert abs(a.std() * np.sqrt(fan_in) - 1) < tol, path


def test_prompts_that_break_the_group_or_chunk_rule_raise():
    """An MoE prefill of 2 x 40 = 80 tokens against groups of 64, and an SSD
    prompt of 200 against chunks of 128, raise ``ValueError`` stating the
    rule (the reference asserts; neither pads)."""
    cfg = _cfg("deepseek-moe-16b")
    _, tp = _params(cfg)
    with pytest.raises(ValueError, match="multiple of min.group_size"):
        tt.forward(tp, cfg, torch.as_tensor(_tokens(cfg, 2, 40)))
    cfg = _cfg("mamba2-130m")
    _, tp = _params(cfg)
    with pytest.raises(ValueError, match="multiple of min.chunk"):
        tt.forward(tp, cfg, torch.as_tensor(_tokens(cfg, 1, 200)))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_the_mixers_on_the_cpu(arch, capsys,
                                                   monkeypatch):
    out = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    tokens = out["tokens"]
    assert tokens.shape == (2, 4) and tokens.dtype == torch.int32
    assert bool(((tokens >= 0) & (tokens < 512)).all())
    assert "generated (2, 4)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", arch, "--smoke", "--max-new", "2"])
