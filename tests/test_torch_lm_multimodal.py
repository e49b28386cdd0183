"""The whisper-small encoder-decoder and qwen2-vl-2b M-RoPE serving paths
in ``repro_torch`` against ``repro``, on the same numpy inputs, on the CPU:
the sinusoidal tables, M-RoPE and the non-causal attention, the M-RoPE ids,
the parameter tree with its ``encoder`` subtree, the encoder, ``forward``
with ``enc_frames=`` and ``patch_embeds=``, prefill-then-decode (logits and
every cache leaf), the decode step's positions, and ``generate`` (greedy
and with JAX's Gumbel draws, patches kept or evicted by ``cache_margin``);
each at the smoke config and at a head-padded variant (4 q-heads padded to
8, as the full configs pad 12 to 16).  Also every config's smoke version
through ``generate`` on the CPU.

Parameters in the layout of JAX's ``init_params``, drawn with numpy,
reach JAX as arrays and the port through ``convert.lm_params``.  JAX's
functions are jitted.  Float tolerances are float32's: rtol 1e-5, atol
1e-5; integers exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_mrope_positions as j_mrope_ids  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params, to_numpy  # noqa: E402
from repro_torch.models import build_mrope_positions  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

_j_forward = jax.jit(j_forward, static_argnums=1,
                     static_argnames=("return_cache", "cache_len"))
_j_decode_step = jax.jit(j_decode_step, static_argnums=1)
_j_encode = jax.jit(jt._encode, static_argnums=1)
_j_generate = jax.jit(jengine.generate, static_argnums=(1, 3),
                      static_argnames=("temperature", "cache_margin"))
TOL = dict(rtol=1e-5, atol=1e-5)
# the smoke configs, and each with its 4 q-heads padded to 8
NAMES = ("whisper-small", "whisper-small+pad", "qwen2-vl-2b",
         "qwen2-vl-2b+pad")
B, S_TEXT, STEPS = 2, 6, 4


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _cfg(name):
    arch, _, variant = name.partition("+")
    cfg = tconfigs.get_smoke(arch)
    if variant == "pad":
        cfg = dataclasses.replace(cfg, head_pad_multiple=8)
        assert cfg.padded_heads == 8 != cfg.n_heads
    elif variant:
        # more patches than new tokens
        cfg = dataclasses.replace(cfg, vision_patches=int(variant))
    return cfg


def _jcfg(cfg):
    """The JAX twin of a port config (the same fields, JAX dtypes)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = jnp.dtype(str(cfg.dtype).split(".")[1])
    fields["param_dtype"] = jnp.dtype(str(cfg.param_dtype).split(".")[1])
    if cfg.moe is not None:
        fields["moe"] = JMoEConfig(**dataclasses.asdict(cfg.moe))
    return JModelConfig(**fields)


_PARAMS = {}


def _params(cfg):
    """A parameter tree of JAX's ``init_params`` layout for ``cfg``, drawn
    with numpy (normal / sqrt(fan_in) weights, the embedding's fan-in its
    width so that tokens weigh as much as whisper's sinusoidal positions,
    norm scales 0.1 times a normal so that ``1 + scale`` is exercised):
    (JAX's arrays, the numpy tree, the port's copy through
    ``convert.lm_params``)."""
    key = (cfg.name, cfg.head_pad_multiple, cfg.vision_patches)
    if key not in _PARAMS:
        rng = np.random.default_rng(len(_PARAMS) + 7)
        tree = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                    _jcfg(cfg)))

        def draw(path, leaf):
            x = rng.standard_normal(leaf.shape).astype(np.float32)
            name = jax.tree_util.keystr(path)
            if "norm" in name:
                return 0.1 * x
            if name == "['embed']":
                return x / np.sqrt(leaf.shape[-1])
            return x / np.sqrt(np.prod(leaf.shape[int("runs" in name):-1]))

        npt = jax.tree_util.tree_map_with_path(draw, tree)
        _PARAMS[key] = (jax.tree_util.tree_map(jnp.asarray, npt), npt,
                        lm_params(npt))
    return _PARAMS[key]


def _inputs(cfg, n: int, seed: int, b: int = B):
    """(tokens (b, n), the forward's extras) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)
    extra = {}
    if cfg.encoder_layers:
        extra["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.vision_patches:
        extra["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return toks, extra


def _j(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


def _t(extra):
    return {k: torch.as_tensor(v) for k, v in extra.items()}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(24, 64), (1500, 768)])
def test_sinusoidal_tables_match_jax(n, d):
    """The table and the embedding at positions below ``n``.  Each side's
    float32 ``exp`` may round a frequency another way by an ulp, and the
    angle ``position * frequency`` carries that as an error of up to
    ``n * 2**-23``: within 1e-5 at the smoke config's 24 frames, and
    within ``n * 2**-22`` (3.6e-4) at whisper's 1500."""
    tol = dict(rtol=1e-5, atol=max(1e-5, n * 2.0 ** -22))
    _close(tl.sinusoidal_positions(n, d), jl.sinusoidal_positions(n, d),
           **tol)
    pos = np.random.default_rng(1).integers(0, n, (2, 5))
    _close(tl.sinusoidal_at(torch.as_tensor(pos), d),
           jl.sinusoidal_at(jnp.asarray(pos), d), **tol)


@pytest.mark.parametrize("sections,head_dim,theta", [
    ((4, 2, 2), 16, 10_000.0), ((16, 24, 24), 128, 1_000_000.0)])
def test_apply_mrope_matches_jax(sections, head_dim, theta):
    """Each component's slice of the frequencies, against JAX's loop; and
    sections that do not fill the half-dim raise."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 700, (3, 2, 7)).astype(np.int32)
    got = tl.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections,
                         theta)
    _close(got, jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                               theta))
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos),
                       sections[:2], theta)


@pytest.mark.parametrize("case", ["cross", "self_softcap", "window"])
def test_non_causal_dense_attention_matches_jax(case):
    """``dense_attention(causal=False)``: queries against a longer key
    sequence (cross-attention), soft-capped self-attention, and a window
    alone."""
    rng = np.random.default_rng(3)
    s, t = (5, 24) if case == "cross" else (12, 12)
    q = rng.standard_normal((2, s, 2, 2, 8)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, t, 2, 8)).astype(np.float32)
    kw = {"cross": {}, "self_softcap": dict(softcap=2.0),
          "window": dict(window=4)}[case]
    got = tl.dense_attention(*map(torch.as_tensor, (q, k, v)), causal=False,
                             **kw)
    _close(got, jl.dense_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=False, **kw))


@pytest.mark.parametrize("patches", [0, 4, 9, 64])
def test_build_mrope_positions_equal_jax(patches):
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen2-vl-2b"),
                              vision_patches=patches)
    got = build_mrope_positions(cfg, 3, patches + 7)
    want = np.asarray(j_mrope_ids(_jcfg(cfg), 3, patches + 7))
    assert got.shape == want.shape == (3, 3, patches + 7)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The parameter tree
# ---------------------------------------------------------------------------

def _paths(tree):
    return [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_matches_jax(name):
    """``init_params`` gives JAX's tree (the ``encoder`` subtree and the
    cross-attention leaves included), shapes and dtypes, zero norm scales
    and the normal / sqrt(fan_in) law (within max(0.1, four standard
    errors) of the std); ``lm_params`` carries a JAX tree over leaf for
    leaf; ``compute_params`` keeps every norm scale, ``xnorm`` and the
    encoder's included, in float32."""
    cfg = _cfg(name)
    want = _paths(jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                       _jcfg(cfg))))
    tp = tt.init_params(torch.Generator().manual_seed(0), cfg)
    got = _paths(to_numpy(tp))
    assert [p for p, _ in got] == [p for p, _ in want]
    if cfg.encoder_layers:
        assert "['runs'][0]['xwk']" in dict(got)
        assert "['encoder']['runs'][0]['wq']" in dict(got)
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if "norm" in path:
            assert not a.any(), path
            continue
        fan_in = int(np.prod(a.shape[int("runs" in path):-1]))
        tol = max(0.1, 4 / np.sqrt(2 * a.size))
        assert abs(a.std() * np.sqrt(fan_in) - 1) < tol, path
    _, npt, conv = _params(cfg)
    for (pa, a), (pb, b) in zip(_paths(to_numpy(conv)), _paths(npt)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    served = tt.compute_params(conv, dataclasses.replace(
        cfg, dtype=torch.bfloat16))
    for path, x in _paths(served):
        want_dt = torch.float32 if "norm" in path else torch.bfloat16
        assert x.dtype == want_dt, path


# ---------------------------------------------------------------------------
# The encoder, forward, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["whisper-small", "whisper-small+pad"])
def test_encode_matches_jax(name):
    """The encoder's output: the sinusoidal table, non-causal blocks (the
    padded variant's 8 streams gather-expanded from 4 heads), the final
    norm."""
    cfg = _cfg(name)
    jp, _, tp = _params(cfg)
    _, extra = _inputs(cfg, 1, seed=0)
    got = tt._encode(tp, cfg, torch.as_tensor(extra["enc_frames"]))
    _close(got, _j_encode(jp, _jcfg(cfg), jnp.asarray(extra["enc_frames"])))


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    """Logits of the patches and text; whisper's also at positions given
    (offset by 5)."""
    cfg = _cfg(name)
    jp, _, tp = _params(cfg)
    toks, extra = _inputs(cfg, S_TEXT + STEPS, seed=1)
    want = _j_forward(jp, _jcfg(cfg), jnp.asarray(toks), **_j(extra))
    got = tt.forward(tp, cfg, torch.as_tensor(toks), **_t(extra))
    assert got.shape == (B, toks.shape[1] + cfg.vision_patches,
                         cfg.padded_vocab)
    _close(got, want)
    if cfg.encoder_layers:
        # positions given: the sinusoidal embeddings read them
        pos = np.arange(toks.shape[1]) + 5 + np.zeros_like(toks)
        want = _j_forward(jp, _jcfg(cfg), jnp.asarray(toks),
                          positions=jnp.asarray(pos), **_j(extra))
        got = tt.forward(tp, cfg, torch.as_tensor(toks),
                         positions=torch.as_tensor(pos), **_t(extra))
        _close(got, want)


def _cache_equal(got, want):
    got = to_numpy(got)
    assert sorted(got) == sorted(want)
    assert int(got["pos"]) == int(want["pos"])
    if "enc_out" in want:
        _close(got["enc_out"], want["enc_out"])
    for a, b in zip(got["runs"], want["runs"], strict=True):
        assert sorted(a) == sorted(b)
        for leaf in a:
            assert a[leaf].shape == b[leaf].shape, leaf
            _close(a[leaf], b[leaf])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_jax(name):
    """A prefill of the patches and 6 tokens into a cache that holds them
    and 4 more (the text's 6 + 4 + the patches), then 4 decode steps:
    logits, ``pos`` and every cache leaf (``k``, ``v``, and whisper's
    ``xk``, ``xv``, ``enc_out``) equal JAX's after the prefill and after
    each step."""
    cfg = _cfg(name)
    jcfg = _jcfg(cfg)
    jp, _, tp = _params(cfg)
    toks, extra = _inputs(cfg, S_TEXT + STEPS, seed=2)
    cache_len = S_TEXT + STEPS + cfg.vision_patches
    jlg, jcache = _j_forward(jp, jcfg, jnp.asarray(toks[:, :S_TEXT]),
                             return_cache=True, cache_len=cache_len,
                             **_j(extra))
    tlg, tcache = tt.forward(tp, cfg, torch.as_tensor(toks[:, :S_TEXT]),
                             return_cache=True, cache_len=cache_len,
                             **_t(extra))
    _close(tlg, jlg)
    _cache_equal(tcache, jcache)
    if cfg.encoder_layers:
        assert tcache["runs"][0]["xk"].shape == (
            cfg.n_layers, B, cfg.encoder_frames, cfg.n_kv, cfg.head_dim)
    for t in range(S_TEXT, S_TEXT + STEPS):
        jlg, jcache = _j_decode_step(jp, jcfg, jcache,
                                     jnp.asarray(toks[:, t:t + 1]))
        tlg, tcache = tt.decode_step(tp, cfg, tcache,
                                     torch.as_tensor(toks[:, t:t + 1]))
        _close(tlg, jlg)
        _cache_equal(tcache, jcache)


@pytest.mark.parametrize("name", ["whisper-small", "qwen2-vl-2b"])
def test_decode_against_a_teacher_forced_forward(name):
    """The reference's decode positions, kept.  whisper's decode step at
    ``pos`` equals the teacher-forced forward there (within 1e-5).
    qwen2-vl's prefill gives a text token the M-RoPE ids ``idx - P +
    grid`` and its decode step gives all three ``pos`` (``repro.models.
    transformer`` ``build_mrope_positions`` against ``_attn_decode``), so
    its first decode step differs from the teacher-forced forward by far
    more than rounding (ROADMAP Queue 3); the port's steps equal JAX's in
    both."""
    cfg = _cfg(name)
    jcfg = _jcfg(cfg)
    jp, _, tp = _params(cfg)
    toks, extra = _inputs(cfg, S_TEXT + 1, seed=3)
    p = cfg.vision_patches
    full = tt.forward(tp, cfg, torch.as_tensor(toks), **_t(extra))
    lg, cache = tt.forward(tp, cfg, torch.as_tensor(toks[:, :S_TEXT]),
                           return_cache=True,
                           cache_len=p + S_TEXT + 1, **_t(extra))
    _close(lg[:, -1], full[:, p + S_TEXT - 1])
    step, _ = tt.decode_step(tp, cfg, cache,
                             torch.as_tensor(toks[:, S_TEXT:]))
    _, jcache = _j_forward(jp, jcfg, jnp.asarray(toks[:, :S_TEXT]),
                           return_cache=True, cache_len=p + S_TEXT + 1,
                           **_j(extra))
    jstep, _ = _j_decode_step(jp, jcfg, jcache,
                              jnp.asarray(toks[:, S_TEXT:]))
    _close(step, jstep)
    gap = float((step[:, 0] - full[:, -1]).abs().max())
    if cfg.mrope_sections:
        jfull = np.asarray(_j_forward(jp, jcfg, jnp.asarray(toks),
                                      **_j(extra)))
        assert np.abs(np.asarray(jstep)[:, 0] - jfull[:, -1]).max() > 1e-2
        assert gap > 1e-2, gap
    else:
        assert gap <= 1e-5, gap


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,temperature,margin", [
    ("whisper-small", 0.0, 0), ("whisper-small+pad", 0.8, 0),
    # 4 patches, 6 new tokens: a margin of 0 evicts the first patches
    ("qwen2-vl-2b", 0.0, 0), ("qwen2-vl-2b", 0.0, 4),
    ("qwen2-vl-2b", 0.8, 0), ("qwen2-vl-2b+pad", 0.8, 4),
    # 9 patches, 6 new tokens: the unrolled global caches of the reference
    ("qwen2-vl-2b+9", 0.0, 0)])
def test_generate_matches_jax(name, temperature, margin):
    """``generate``'s tokens equal JAX's exactly, greedy or with the Gumbel
    noise JAX's ``generate`` draws injected (step 0 from the key, step t
    from ``split(key, max_new - 1)[t - 1]``), with the cache sized by the
    reference's rule ``S_text + max_new + cache_margin``."""
    cfg = _cfg(name)
    jp, _, tp = _params(cfg)
    prompt, extra = _inputs(cfg, S_TEXT, seed=4)
    max_new = 6
    key = jax.random.PRNGKey(5)
    want = np.asarray(_j_generate(jp, _jcfg(cfg), jnp.asarray(prompt),
                                  max_new, key, temperature=temperature,
                                  cache_margin=margin, **_j(extra)))
    gumbel = None
    if temperature:
        keys = [key] + list(jax.random.split(key, max_new - 1))
        gumbel = torch.as_tensor(np.stack([np.asarray(jax.random.gumbel(
            k, (B, cfg.padded_vocab), jnp.float32)) for k in keys]))
    got = engine.generate(tp, cfg, prompt, max_new, temperature=temperature,
                          gumbel=gumbel, cache_margin=margin, device="cpu",
                          **extra)
    assert got.dtype == torch.int32 and got.shape == (B, max_new)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_smoke_config_generates_on_the_cpu(arch):
    """No config is refused: each smoke config's random parameters from a
    seed serve 3 greedy tokens through ``generate`` on the CPU (whisper
    with its frames, qwen2-vl with its patches)."""
    cfg = tconfigs.get_smoke(arch)
    g = torch.Generator().manual_seed(0)
    params = tt.init_params(g, cfg)
    prompt, extra = _inputs(cfg, 8, seed=6)
    out = engine.generate(params, cfg, prompt, 3, device="cpu", **extra)
    assert out.shape == (B, 3) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < cfg.vocab)).all())
