"""The LM serving path in ``repro_torch`` against ``repro``, on the same
numpy inputs, on the CPU: the ten architecture configs, the layers
(``rms_norm``, RoPE, the four attention shapes), the flash walks forward
and backward, ``forward`` on the dense, chunked and flash paths,
prefill-then-decode with linear and ring caches, ``generate`` (greedy, and
temperature sampling with JAX's Gumbel draws injected) and the serve
launcher.  The whisper and
qwen2-vl paths are held in tests/test_torch_lm_multimodal.py.

Parameters in the layout of JAX's ``init_params``, drawn with numpy,
reach JAX as arrays and the port through ``convert.lm_params``.  Float
tolerances are float32's: rtol 1e-5, atol 1e-5, unless a test says
otherwise.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.config import pattern_runs as j_pattern_runs  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params, to_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.config import pattern_runs  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

_j_decode_step = jax.jit(j_decode_step, static_argnums=1)
REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
# the attention decoders (the MoE, RG-LRU and SSD configs are held in
# tests/test_torch_lm_mixers.py, whisper and qwen2-vl in
# tests/test_torch_lm_multimodal.py)
PORTED = ("tinyllama-1.1b", "gemma-2b", "yi-34b", "gemma3-12b")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _both(x):
    return jnp.asarray(x), torch.as_tensor(x)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def _same_config(jc, tc):
    assert [f.name for f in dataclasses.fields(tc)] == [
        f.name for f in dataclasses.fields(jc)]
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(b) == f"torch.{jnp.dtype(a).name}", f.name
        elif f.name == "moe":
            assert (a is None) == (b is None)
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    for name in ("padded_vocab", "padded_heads", "d_inner", "ssm_heads"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert pattern_runs(tc) == j_pattern_runs(jc)
    assert [tc.layer_kind(i) for i in range(tc.n_layers)] == [
        jc.layer_kind(i) for i in range(jc.n_layers)]


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    _same_config(jconfigs.get_config(arch), tconfigs.get_config(arch))
    _same_config(jconfigs.get_smoke(arch), tconfigs.get_smoke(arch))
    assert tconfigs.long_context_ok(arch) == jconfigs.long_context_ok(arch)
    assert (tconfigs._mod(arch).IS_DECODER
            == jconfigs._mod(arch).IS_DECODER)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config(arch + "-x")
    if arch == "tinyllama-1.1b":
        assert round(tconfigs.get_config(arch).param_count() / 1e9, 3) == 1.1


# ---------------------------------------------------------------------------
# Layers and the flash walks
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3
    scale = rng.standard_normal((16,)).astype(np.float32)
    (jx, tx), (js, ts) = _both(x), _both(scale)
    _close(tl.rms_norm(tx, ts, 1e-6), jl.rms_norm(jx, js, 1e-6))
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        jsin, jcos = jl.rope_sincos(jnp.asarray(pos), 16, theta)
        tsin, tcos = tl.rope_sincos(torch.as_tensor(pos), 16, theta)
        _close(tsin, jsin)
        _close(tcos, jcos)
        _close(tl.apply_rope(tx, tsin, tcos), jl.apply_rope(jx, jsin, jcos))
    gate, up = rng.standard_normal((2, 2, 3, 7)).astype(np.float32)
    _close(tl.swiglu(*map(torch.as_tensor, (gate, up))),
           jl.swiglu(*map(jnp.asarray, (gate, up))))
    _close(tl.geglu(*map(torch.as_tensor, (gate, up))),
           jl.geglu(*map(jnp.asarray, (gate, up))))


def _qkv(seed, s=12, t=None, g=2, r=2, d=8, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, g, r, d)).astype(np.float32)
    k, v = rng.standard_normal((2, b, t or s, g, d)).astype(np.float32)
    return q, k, v


def _attention(case):
    """(port output, JAX output) of one attention case on seeded inputs."""
    if case.startswith("decode"):
        w, pos = 8, 5 if case == "decode_linear" else 13
        q, k, v = _qkv(1, s=1, t=w)
        jslot = jt._slot_positions(jnp.int32(pos), w)
        tslot = tt._slot_positions(torch.tensor(pos, dtype=torch.int32), w)
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        kw = dict(window=6, softcap=5.0) if case == "decode_ring" else {}
        want = jl.decode_attention(*map(jnp.asarray, (q, k, v)), jslot,
                                   jnp.int32(pos), **kw)
        got = tl.decode_attention(*map(torch.as_tensor, (q, k, v)), tslot,
                                  torch.tensor(pos, dtype=torch.int32), **kw)
        return got, want
    s = 64 if case.startswith(("flash", "pair", "banded")) else 12
    q, k, v = _qkv(2, s=s)
    jargs, targs = map(jnp.asarray, (q, k, v)), map(torch.as_tensor, (q, k, v))
    fn, kw = {
        "causal": ("dense_attention", {}),
        "window": ("dense_attention", dict(window=5)),
        "softcap": ("dense_attention", dict(softcap=2.0, window=7)),
        "pair_chunked": ("pair_chunked_attention", dict(chunk=16,
                                                        softcap=2.0)),
        "banded": ("banded_attention", dict(window=24, chunk=16)),
    }.get(case, (None, None))
    if fn is not None:
        return getattr(tl, fn)(*targs, **kw), getattr(jl, fn)(*jargs, **kw)
    # the flash walks, output and row log-sum-exp
    if case == "flash_causal":
        return (tflash._causal_fwd_walk(*targs, 16, 2.0),
                jflash._causal_fwd_walk(*jargs, 16, 2.0))
    return (tflash._banded_fwd_walk(*targs, 24, 16, 0.0),
            jflash._banded_fwd_walk(*jargs, 24, 16, 0.0))


@pytest.mark.parametrize("case", [
    "causal", "window", "softcap", "pair_chunked", "banded", "decode_linear",
    "decode_ring", "flash_causal", "flash_banded"])
def test_attention_matches_jax(case):
    got, want = _attention(case)
    if isinstance(got, tuple):
        for a, b in zip(got, want):
            _close(a, b)
    else:
        _close(got, want)


def test_flash_walks_take_gradients_and_equal_their_plain_twins():
    """The flash walks equal the pair-chunked and banded walks on the same
    inputs, and the materialized-score attention, which shares no code
    with them; their backward walks give the dq, dk and dv of autograd
    through the materialized-score attention and of JAX's ``custom_vjp``
    walks, with and without a soft-cap (rtol 1e-5, atol 1e-5)."""
    qkv = _qkv(3, s=64)
    q, k, v = map(torch.as_tensor, qkv)
    with torch.no_grad():
        causal = tflash.flash_causal_attention(q, k, v, 16)
        banded = tflash.flash_banded_attention(q, k, v, 24, 16)
        _close(causal, tl.pair_chunked_attention(q, k, v, chunk=16))
        _close(banded, tl.banded_attention(q, k, v, window=24, chunk=16))
        _close(causal, tl.dense_attention(q, k, v))
        _close(banded, tl.dense_attention(q, k, v, window=24))
    dout = np.random.default_rng(4).standard_normal(qkv[0].shape).astype(
        np.float32)
    cases = {
        "causal": (lambda *x: tflash.flash_causal_attention(*x, 16, 2.0),
                   lambda *x: tl.dense_attention(*x, softcap=2.0),
                   lambda *x: jflash.flash_causal_attention(*x, 16, 2.0)),
        "causal_plain": (lambda *x: tflash.flash_causal_attention(*x, 16),
                         lambda *x: tl.dense_attention(*x),
                         lambda *x: jflash.flash_causal_attention(*x, 16)),
        "banded": (lambda *x: tflash.flash_banded_attention(*x, 24, 16, 2.0),
                   lambda *x: tl.dense_attention(*x, window=24, softcap=2.0),
                   lambda *x: jflash.flash_banded_attention(*x, 24, 16,
                                                            2.0)),
    }
    for name, (walk, dense, jwalk) in cases.items():
        grads = []
        for fn in (walk, dense):
            xs = [torch.as_tensor(a).requires_grad_() for a in qkv]
            (fn(*xs) * torch.as_tensor(dout)).sum().backward()
            grads.append([x.grad for x in xs])
        _, vjp = jax.vjp(jwalk, *map(jnp.asarray, qkv))
        for got, via_dense, want in zip(*grads, vjp(jnp.asarray(dout))):
            _close(got, via_dense)
            _close(got, want)


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------

def _smoke(name):
    if name == "gemma-2b-padded":
        # q-heads padded 4 -> 8, vocab padded 100 -> 256, logit softcap
        return dataclasses.replace(
            tconfigs.get_smoke("gemma-2b"), head_pad_multiple=8, vocab=100,
            logit_softcap=30.0)
    return tconfigs.get_smoke(name)


def _jcfg(cfg):
    """The JAX twin of a port config (the same fields, JAX dtypes)."""
    from repro.models.config import ModelConfig, MoEConfig
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = jnp.dtype(str(cfg.dtype).split(".")[1])
    fields["param_dtype"] = jnp.dtype(str(cfg.param_dtype).split(".")[1])
    if cfg.moe is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(cfg.moe))
    return ModelConfig(**fields)


_PARAMS = {}


def _params(cfg):
    """A parameter tree of JAX's ``init_params`` layout for ``cfg``, drawn
    with numpy (normal / sqrt(fan_in) weights, and norm scales of 0.1
    times a normal so that the ``1 + scale`` is exercised), and the port's
    copy through ``convert.lm_params``."""
    key = (cfg.name, cfg.vocab, cfg.head_pad_multiple)
    if key not in _PARAMS:
        rng = np.random.default_rng(len(_PARAMS))
        tree = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                    _jcfg(cfg)))

        def draw(path, leaf):
            x = rng.standard_normal(leaf.shape).astype(np.float32)
            name = jax.tree_util.keystr(path)
            if "norm" in name:
                return 0.1 * x
            return x / np.sqrt(np.prod(leaf.shape[int("runs" in name):-1]))

        jp = jax.tree_util.tree_map_with_path(draw, tree)
        _PARAMS[key] = jax.tree_util.tree_map(jnp.asarray, jp), lm_params(jp)
    return _PARAMS[key]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


_PATHS = {
    # dense everywhere (local layers mask their window)
    "dense": (16, dict(flash_attention=False)),
    # the pair-chunked and banded walks, two 16-token chunks
    "chunked": (32, dict(dense_attn_max_seq=8, attn_chunk=16,
                         flash_attention=False)),
    # the flash walks, two 16-token chunks
    "flash": (32, dict(dense_attn_max_seq=8, attn_chunk=16)),
    # 24 tokens are no multiple of 16: the flash walks take one chunk
    "flash_ragged": (24, dict(dense_attn_max_seq=8, attn_chunk=16)),
}


@pytest.mark.parametrize("name,path", [
    (n, p) for n in ("tinyllama-1.1b", "gemma-2b", "gemma-2b-padded",
                     "gemma3-12b") for p in ("dense", "chunked", "flash")]
    + [("gemma3-12b", "flash_ragged")])
def test_forward_matches_jax(name, path):
    s, over = _PATHS[path]
    cfg = dataclasses.replace(_smoke(name), **over)
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 2, s)
    want = np.asarray(j_forward(jp, _jcfg(cfg), jnp.asarray(toks)))
    got = tt.forward(tp, cfg, torch.as_tensor(toks))
    _close(got, want)
    if cfg.padded_vocab != cfg.vocab:
        assert bool((got[..., cfg.vocab:] < -1e29).all())


@pytest.mark.parametrize("name", ["gemma-2b-padded", "gemma3-12b"])
def test_bfloat16_forward_tracks_jax(name):
    """In bfloat16, weights cast once by ``compute_params`` give bit for bit
    the logits of a cast at each use, as the reference casts; and the
    logits stay within the bfloat16 tolerance of JAX's: RMS difference at
    most 0.05 and largest at most 0.25 of the logits' standard deviation
    (bfloat16 keeps 8 significant bits; the measured values are 0.010-0.016
    and 0.046-0.082)."""
    cfg = dataclasses.replace(_smoke(name), dtype=torch.bfloat16)
    jp, tp = _params(_smoke(name))
    toks = _tokens(cfg, 2, 16)
    got = tt.forward(tt.compute_params(tp, cfg), cfg, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tt.forward(tp, cfg, torch.as_tensor(toks)))
    want = np.asarray(j_forward(jp, _jcfg(cfg), jnp.asarray(toks)),
                      np.float32)[..., :cfg.vocab]
    diff = got.float().numpy()[..., :cfg.vocab] - want
    assert np.sqrt(np.mean(diff ** 2)) <= 0.05 * want.std()
    assert np.abs(diff).max() <= 0.25 * want.std()


def _cache_equal(got, want):
    assert int(got["pos"]) == int(want["pos"])
    assert len(got["runs"]) == len(want["runs"])
    for a, b in zip(got["runs"], want["runs"]):
        assert sorted(a) == sorted(b) == ["k", "v"]
        for name in ("k", "v"):
            assert a[name].shape == b[name].shape
            _close(a[name], b[name])


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "gemma-2b-padded",
                                  "gemma3-12b"])
def test_prefill_then_decode_matches_jax(name):
    """Prefill 12 tokens into a cache of 18, then decode 5: logits, ``pos``
    and every run's k/v equal JAX's after the prefill and after each
    step.  gemma3's smoke window of 8 is under the prompt, so its local
    runs hold rolled ring caches."""
    cfg = _smoke(name)
    jcfg = _jcfg(cfg)
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 2, 17, seed=1)
    jlg, jcache = j_forward(jp, jcfg, jnp.asarray(toks[:, :12]),
                            return_cache=True, cache_len=18)
    tlg, tcache = tt.forward(tp, cfg, torch.as_tensor(toks[:, :12]),
                             return_cache=True, cache_len=18)
    _close(tlg, jlg)
    _cache_equal(to_numpy(tcache), jcache)
    if name == "gemma3-12b":
        widths = [r["k"].shape[2] for r in tcache["runs"]]
        assert widths == [cfg.window, 18], widths
    for t in range(12, 17):
        jlg, jcache = _j_decode_step(jp, jcfg, jcache,
                                     jnp.asarray(toks[:, t:t + 1]))
        tlg, tcache = tt.decode_step(tp, cfg, tcache,
                                     torch.as_tensor(toks[:, t:t + 1]))
        _close(tlg, jlg)
        _cache_equal(to_numpy(tcache), jcache)


@pytest.mark.parametrize("name", ["gemma-2b-padded", "gemma3-12b"])
def test_decode_from_an_empty_cache_matches_forward(name):
    """Token by token from ``init_cache``, ``decode_step`` gives the
    full-sequence forward's logits (gemma3's window of 8 wraps its ring
    caches of 8 twice over 20 tokens)."""
    cfg = _smoke(name)
    _, tp = _params(cfg)
    toks = torch.as_tensor(_tokens(cfg, 2, 20, seed=4))
    full = tt.forward(tp, cfg, toks)
    cache = tt.init_cache(cfg, 2, 24, "cpu")
    steps = []
    for t in range(20):
        lg, cache = tt.decode_step(tp, cfg, cache, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    assert int(cache["pos"]) == 20
    _close(torch.stack(steps, dim=1), full)


def test_init_params_tree_and_law():
    """The port's random parameters have JAX's tree, shapes and dtypes, zero
    norm scales, and the normal / sqrt(fan_in) law."""
    for name in PORTED:
        cfg = tconfigs.get_smoke(name)
        tp = tt.init_params(torch.Generator().manual_seed(0), cfg)
        jp = jax.eval_shape(lambda c=cfg: j_init_params(
            jax.random.PRNGKey(0), _jcfg(c)))
        assert sorted(tp) == sorted(jp)
        flat_t = jax.tree_util.tree_leaves_with_path(to_numpy(tp))
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
        for (path, a), (_, b) in zip(flat_t, flat_j):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if "norm" in jax.tree_util.keystr(path):
                assert not a.any(), path
            else:
                stacked = "runs" in jax.tree_util.keystr(path)
                fan_in = int(np.prod(a.shape[1 if stacked else 0:-1]))
                assert abs(a.std() * np.sqrt(fan_in) - 1) < 0.1, path


# ---------------------------------------------------------------------------
# generate and the launcher
# ---------------------------------------------------------------------------

def test_generate_greedy_matches_jax_where_the_margin_is_clear():
    """Greedy tokens equal JAX's wherever JAX's top-1/top-2 logit margin
    exceeds 1e-4 (teacher-forced on JAX's tokens); a row stops being
    compared after a token within the margin.  At this size no token is
    within it."""
    cfg = _smoke("tinyllama-1.1b")
    jp, tp = _params(cfg)
    prompt = _tokens(cfg, 2, 8, seed=2)
    want = np.asarray(jengine.generate(jp, _jcfg(cfg), jnp.asarray(prompt),
                                       8))
    got = engine.generate(tp, cfg, prompt, 8, device="cpu").numpy()
    assert got.dtype == np.int32 and got.shape == (2, 8)
    logits = np.asarray(j_forward(jp, _jcfg(cfg), jnp.asarray(
        np.concatenate([prompt, want], axis=1))))[:, 7:15]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    unclear = 0
    for b in range(2):
        for t in range(8):
            if not clear[b, t]:
                unclear += 1
                break
            assert got[b, t] == want[b, t], (b, t)
    assert unclear == 0


def test_generate_temperature_with_jax_gumbel_draws():
    """With the Gumbel noise JAX's ``generate`` draws (step 0 from the key,
    step t from ``split(key, max_new - 1)[t - 1]``) injected, the port
    samples JAX's tokens."""
    cfg = _smoke("gemma3-12b")
    jp, tp = _params(cfg)
    prompt = _tokens(cfg, 2, 10, seed=3)
    key, max_new, temp = jax.random.PRNGKey(4), 6, 0.8
    keys = [key] + list(jax.random.split(key, max_new - 1))
    gumbel = np.stack([np.asarray(jax.random.gumbel(
        k, (2, cfg.padded_vocab), jnp.float32)) for k in keys])
    want = np.asarray(jengine.generate(jp, _jcfg(cfg), jnp.asarray(prompt),
                                       max_new, key=key, temperature=temp))
    got = engine.generate(tp, cfg, prompt, max_new, temperature=temp,
                          gumbel=torch.as_tensor(gumbel), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # one step alone: temperature_sample against jax.random.categorical
    logits = np.random.default_rng(5).standard_normal(
        (3, 40)).astype(np.float32)
    jkey = jax.random.PRNGKey(6)
    g = np.asarray(jax.random.gumbel(jkey, (3, 40), jnp.float32))
    np.testing.assert_array_equal(
        engine.temperature_sample(torch.as_tensor(logits), 0.7,
                                  gumbel=torch.tensor(g)).numpy(),
        np.asarray(jengine.temperature_sample(jnp.asarray(logits), jkey,
                                              0.7)))
    drawn = engine.generate(tp, cfg, prompt, 3, temperature=temp,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert drawn.shape == (2, 3) and bool((drawn < cfg.vocab).all())
    with pytest.raises(ValueError, match="gumbel"):
        engine.generate(tp, cfg, prompt, 3, temperature=temp,
                        gumbel=torch.as_tensor(gumbel), device="cpu")


@pytest.mark.parametrize("extra", [[], ["--temperature", "0.8"],
                                   ["--edge-host"],
                                   ["--arch", "whisper-small"],
                                   ["--arch", "qwen2-vl-2b"]])
def test_serve_launcher_runs_on_the_cpu(extra, capsys):
    out = tserve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "8",
                       "--max-new", "4", *extra])
    if extra == ["--edge-host"]:
        assert out is None
        assert "completed" in capsys.readouterr().out
        return
    tokens = out["tokens"]
    assert tokens.shape == (2, 4) and tokens.dtype == torch.int32
    assert bool(((tokens >= 0) & (tokens < 512)).all())
    assert out["prefill_ms"] > 0 and out["decode_ms_per_step"] > 0
    assert "generated (2, 4)" in capsys.readouterr().out


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _smoke("tinyllama-1.1b")
    _, tp = _params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.generate(tp, cfg, _tokens(cfg, 1, 4), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--smoke", "--max-new", "2"])


def test_importing_the_lm_port_leaves_jax_out():
    code = ("import sys; import repro_torch.models, repro_torch.configs, "
            "repro_torch.models.moe, repro_torch.models.rglru, "
            "repro_torch.models.ssd, repro_torch.configs.whisper_small, "
            "repro_torch.configs.qwen2_vl_2b, "
            "repro_torch.serving.engine, repro_torch.launch.serve; "
            "[repro_torch.configs.get_config(a) for a in "
            "repro_torch.configs.ARCHS]; "
            "[repro_torch.launch.serve.main(['--arch', a, '--smoke', "
            "'--device', 'cpu', '--batch', '1', '--prompt-len', '4', "
            "'--max-new', '2']) for a in ('whisper-small', 'qwen2-vl-2b')]; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.split()[-2:] == ["False", "False"]
