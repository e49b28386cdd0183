"""The LM training path of ``repro_torch`` against ``repro``, on the same
numpy inputs, on the CPU: the schedules, AdamW (the stacked-norm decay
rule included), ``cross_entropy``, the loss and grads of the tinyllama,
gemma3 and padded gemma smoke configs through both flash backward walks
(and under remat), microbatch accumulation, the full train step, the
token pipeline, checkpoints in both directions (and the port's bf16 round
trip), a preemption restart, budget deferral on JAX's harvest trace, the
train launcher and ``convert.train_state``.

Parameters in the layout of JAX's ``init_params``, drawn with numpy,
reach JAX as arrays and the port through ``convert.lm_params``.  Float
tolerances are float32's, rtol 1e-5 and atol 1e-5, unless a test says
otherwise; integers (steps, the step counter, deferrals) are exact.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.core.energy import harvest_trace as j_harvest_trace  # noqa: E402
from repro.data.lm import LMTask as JTask  # noqa: E402
from repro.data.lm import lm_batches as j_lm_batches  # noqa: E402

from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.convert import lm_params, to_numpy, train_state  # noqa: E402
from repro_torch.data.lm import LMTask, lm_batches  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_lm import _jcfg, _params, _smoke, _tokens  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
# both flash walks: two 16-token chunks past a dense limit of 8
FLASH = dict(dense_attn_max_seq=8, attn_chunk=16)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _tree_close(got, want, **tol):
    """Port tree against JAX tree, leaf by leaf in JAX's order."""
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        _close(to_numpy(a), b, **tol)


# ---------------------------------------------------------------------------
# Schedules, AdamW, cross-entropy
# ---------------------------------------------------------------------------

def test_schedules_match_jax():
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.array([joptim.warmup_cosine(jnp.asarray(s), 3e-4, 10, 100)
                     for s in steps])
    got = toptim.warmup_cosine(torch.as_tensor(steps), 3e-4, 10, 100)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-6, atol=0)
    want_c = joptim.constant_lr(jnp.asarray(steps), 0.5)
    got_c = toptim.constant_lr(torch.as_tensor(steps), 0.5)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _opt_tree(seed, scale=1.0):
    """A stacked tree of the LM's shapes: matrices, stacked norm scales
    (layers, d) and a final norm (d,)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"embed": draw(32, 8), "final_norm": draw(8),
            "runs": [{"norm1": draw(3, 8), "wq": draw(3, 8, 2, 4),
                      "mlp_up": draw(3, 8, 16)}],
            "unembed": draw(8, 32)}


@pytest.mark.parametrize("opt", [
    dict(), dict(weight_decay=0.0), dict(clip_norm=0.0),
    dict(moment_dtype="bfloat16"), dict(clip_norm=0.5, b2=0.99)])
def test_adamw_update_matches_jax(opt):
    """Three AdamW steps on identical numpy-fed grads: params, moments,
    step counter and grad norm.  bf16 moments are held within one bf16
    step (rtol 2**-7): a one-ulp float32 difference in a moment's update
    can round it the other way, and the next update then moves that
    parameter by up to lr * 2**-7 more or less (atol 2.4e-4 at lr 0.03)."""
    jopt = dict(opt)
    topt = dict(opt)
    mtol, ptol = dict(rtol=1e-6, atol=1e-7), dict(rtol=1e-6, atol=1e-6)
    if "moment_dtype" in opt:
        jopt["moment_dtype"] = jnp.bfloat16
        topt["moment_dtype"] = torch.bfloat16
        mtol = dict(rtol=2.0 ** -7, atol=1e-7)
        ptol = dict(rtol=1e-6, atol=0.03 * 2.0 ** -7)
    jcfg, tcfg = joptim.OptConfig(**jopt), toptim.OptConfig(**topt)
    params = _opt_tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = lm_params(params)
    jo, to = joptim.adamw_init(jp, jcfg), toptim.adamw_init(tp, tcfg)
    for i in range(3):
        grads = _opt_tree(10 + i, scale=0.3)
        lr = np.float32(1e-2 * (i + 1))
        jp, jo, jn = joptim.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), jo, jcfg,
            jnp.asarray(lr))
        tp, to, tn = toptim.adamw_update(tp, lm_params(grads), to, tcfg,
                                         torch.as_tensor(lr))
        _close(tn, jn, rtol=1e-6, atol=0)
        _tree_close(tp, jp, **ptol)
        _tree_close(to["m"], jo["m"], **mtol)
        _tree_close(to["v"], jo["v"], **mtol)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        assert to["step"].dtype == torch.int32
        assert to["m"]["embed"].dtype == tcfg.moment_dtype


def test_weight_decay_takes_the_stacked_norms_and_not_the_final_norm():
    """With zero grads only the decay moves a leaf: every leaf of two or
    more dims of the stacked tree (``runs[0]["norm1"]``, (layers, d),
    included) shrinks by ``lr * wd * p``; ``final_norm`` stays."""
    cfg = toptim.OptConfig(weight_decay=0.5)
    tp = lm_params(_opt_tree(1))
    zeros = tree_map(torch.zeros_like, tp)
    new, _, _ = toptim.adamw_update(tp, zeros, toptim.adamw_init(tp, cfg),
                                    cfg, torch.tensor(0.1))
    assert torch.equal(new["final_norm"], tp["final_norm"])
    for name in ("norm1", "wq", "mlp_up"):
        torch.testing.assert_close(new["runs"][0][name],
                                   tp["runs"][0][name] * (1 - 0.1 * 0.5))


def test_global_norm_and_cross_entropy_match_jax():
    tree = _opt_tree(2)
    _close(toptim.global_norm(lm_params(tree)),
           joptim.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)),
           rtol=1e-6, atol=0)
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jtrain.cross_entropy(
            jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = ttrain.cross_entropy(
            torch.as_tensor(logits).bfloat16(), torch.as_tensor(labels),
            None if m is None else torch.as_tensor(m))
        assert got.dtype == torch.float32
        _close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Loss, grads, steps
# ---------------------------------------------------------------------------

_GRAD_CASES = {
    "tinyllama-1.1b": FLASH,
    "tinyllama-1.1b+remat": dict(FLASH, remat="full"),
    "tinyllama-1.1b+dense": {},
    "gemma3-12b": FLASH,
    "gemma3-12b+remat": dict(FLASH, remat="full"),
    "gemma-2b-padded": FLASH,
    # the MoE, RG-LRU, SSD, encoder-decoder and M-RoPE mixers
    "deepseek-moe-16b": {},
    "grok-1-314b": {},
    "recurrentgemma-2b": {},
    "mamba2-130m": {},
    "whisper-small": {},
    "qwen2-vl-2b": {},
}


def _extras(cfg, b, seed=5) -> dict:
    """Standard-normal ``enc_frames`` for an encoder config and
    ``patch_embeds`` for a vision config, (B, frames or patches, D)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_layers:
        out["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.vision_patches:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return out


def _case_cfg(case):
    return dataclasses.replace(_smoke(case.split("+")[0]),
                               **_GRAD_CASES[case])


@pytest.mark.parametrize("case", list(_GRAD_CASES))
def test_loss_and_grads_match_jax(case):
    """The loss and every parameter's gradient of a (B=2, S=32) batch,
    against ``jax.value_and_grad`` of JAX's loss: through both flash
    backward walks (gemma3's local layers take the banded walk, its
    global layer the causal one; 32 tokens in chunks of 16), under remat,
    on the dense path, and with padded q-heads and vocabulary; and the
    smoke configs of the MoE FFN (deepseek with shared experts, grok with
    softcaps), RG-LRU, SSD, whisper's encoder-decoder (with its frames)
    and qwen2-vl's M-RoPE (with its patches, only the text scored).
    Grads within atol 1e-5 (their largest magnitudes are 0.1-1)."""
    cfg = _case_cfg(case)
    jp, tp = _params(cfg)
    batch = dict(tokens=_tokens(cfg, 2, 33), **_extras(cfg, 2))
    (jl, _), jg = jax.value_and_grad(jtrain.make_loss_fn(_jcfg(cfg)),
                                     has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, aux, tg = ttrain.value_and_grad(
        ttrain.make_loss_fn(cfg), tp,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(tl, jl)
    assert torch.equal(aux["loss"], tl)
    _tree_close(tg, jg)


def test_flash_remat_grads_equal_the_plain_run():
    """Remat recomputes each layer in the backward: the same grads, bit
    for bit, as without it."""
    cfg = _case_cfg("gemma3-12b")
    _, tp = _params(cfg)
    batch = {"tokens": torch.as_tensor(_tokens(cfg, 2, 33))}
    _, _, plain = ttrain.value_and_grad(ttrain.make_loss_fn(cfg), tp, batch)
    remat = dataclasses.replace(cfg, remat="full")
    _, _, again = ttrain.value_and_grad(ttrain.make_loss_fn(remat), tp, batch)
    for a, b in zip(leaves(plain), leaves(again)):
        assert torch.equal(a, b)


def _hyper(**kw):
    j = jtrain.TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10, **kw)
    t = ttrain.TrainHyper(peak_lr=1e-3, warmup=1, total_steps=10, **kw)
    return j, t


def _states(cfg):
    jp, tp = _params(cfg)
    jo = joptim.adamw_init(jp, joptim.OptConfig())
    return ({"params": jp, "opt": jo},
            {"params": tp, "opt": toptim.adamw_init(tp, toptim.OptConfig())})


def test_train_steps_match_jax():
    """Two train steps of the tinyllama smoke config through the flash
    walks (B=4, S=32).  Step 0 runs at lr 0; step 1's AdamW moves each
    parameter by about ``lr * sign(g)``, so a gradient entry within
    rounding of zero can flip sign between the two sides and move by 2 lr:
    params are held where the port's |g| of step 1 exceeds 1e-4 or is 0
    (the rows of tokens not in the batch), and the excluded count is
    reported.  Loss, grad norm, lr and moments within
    1e-5, the step counter exact."""
    cfg = _case_cfg("tinyllama-1.1b")
    jh, th = _hyper()
    js, ts = _states(cfg)
    jstep = jax.jit(jtrain.make_train_step(_jcfg(cfg), jh))
    tstep = ttrain.make_train_step(cfg, th)
    task = JTask(vocab=cfg.vocab, seq_len=32, batch=4)
    for i in range(2):
        toks = np.array(j_lm_batches(task, i)["tokens"])
        if i == 1:
            _, _, g1 = ttrain.value_and_grad(
                ttrain.make_loss_fn(cfg), ts["params"],
                {"tokens": torch.as_tensor(toks)})
        js, jm = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tstep(ts, {"tokens": torch.as_tensor(toks)})
        for k in ("loss", "grad_norm", "lr"):
            _close(tm[k], jm[k])
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 2
    _tree_close(ts["opt"]["m"], js["opt"]["m"])
    _tree_close(ts["opt"]["v"], js["opt"]["v"], rtol=1e-5, atol=1e-8)
    excluded = 0
    for got, want, g in zip(leaves(ts["params"]),
                            jax.tree_util.tree_leaves(js["params"]),
                            leaves(g1)):
        clear = (g.abs().numpy() > 1e-4) | (g.numpy() == 0)
        excluded += int((~clear).sum())
        _close(got.numpy()[clear], np.asarray(want)[clear])
    print(f"params held where |g| > 1e-4 or g == 0; excluded {excluded}")


def test_microbatch_accumulation_matches_full_batch_and_jax():
    """Microbatches of 2 over a batch of 8: loss and grads (the first
    moment after one step is 0.1 times the clipped grad) within 1e-5 of
    the full batch's and of JAX's microbatched step."""
    cfg = _case_cfg("gemma3-12b")
    jh, th = _hyper(microbatch=2)
    _, th_full = _hyper()
    js, ts = _states(cfg)
    task = JTask(vocab=cfg.vocab, seq_len=32, batch=8)
    toks = np.array(j_lm_batches(task, 0)["tokens"])
    _, jm = jax.jit(jtrain.make_train_step(_jcfg(cfg), jh))(
        js, {"tokens": jnp.asarray(toks)})
    tm_state, tm = ttrain.make_train_step(cfg, th)(
        ts, {"tokens": torch.as_tensor(toks)})
    full_state, full = ttrain.make_train_step(cfg, th_full)(
        ts, {"tokens": torch.as_tensor(toks)})
    for k in ("loss", "grad_norm"):
        _close(tm[k], jm[k])
        _close(tm[k], full[k])
    _tree_close(tm_state["opt"]["m"], full_state["opt"]["m"], rtol=1e-5,
                atol=1e-7)
    with pytest.raises(ValueError, match="microbatch"):
        ttrain.make_train_step(cfg, _hyper(microbatch=3)[1])(
            ts, {"tokens": torch.as_tensor(toks)})


def test_init_train_state_layout():
    from repro_torch.core.compression import CompressionConfig
    cfg = _smoke("tinyllama-1.1b")
    hyper = ttrain.TrainHyper()
    state = ttrain.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    hyper, CompressionConfig())
    jstate = jax.eval_shape(lambda: jtrain.init_train_state(
        jax.random.PRNGKey(0), _jcfg(cfg), jtrain.TrainHyper(),
        jtrain.step.CompressionConfig()))
    got, want = leaves(state), jax.tree_util.tree_leaves(jstate)
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]
    assert [str(t.dtype) for t in got] == [f"torch.{s.dtype}" for s in want]
    assert all(not bool(t.any()) for t in leaves(state["ef"]))
    assert "ef" not in ttrain.init_train_state(
        torch.Generator().manual_seed(0), cfg, hyper)


# ---------------------------------------------------------------------------
# Token pipeline
# ---------------------------------------------------------------------------

def test_lm_batches_are_pure_and_hold_the_bigram_rule(monkeypatch):
    """A batch is a pure function of (task, step); steps differ; rows are
    whole templates whose odd positions follow the bigram rule but for
    about 5% of noise; the shapes and dtype are JAX's."""
    task = LMTask(vocab=512, seq_len=300, batch=4, seed=3)
    a = lm_batches(task, 5, device="cpu")["tokens"]
    assert torch.equal(a, lm_batches(task, 5, device="cpu")["tokens"])
    assert not torch.equal(a, lm_batches(task, 6, device="cpu")["tokens"])
    want = j_lm_batches(JTask(vocab=512, seq_len=300, batch=4), 5)["tokens"]
    assert tuple(a.shape) == tuple(want.shape) == (4, 301)
    assert a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 512
    tmpl = a[:, :256]
    odd = tmpl[:, 1::2]
    follows = (odd == (tmpl[:, 0::2] + 1) % 512).float().mean()
    assert 0.85 < float(follows) < 0.97
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_batches(task, 0)


def test_shape_cells_equal_jax():
    from repro.launch.shapes import SHAPES as J_SHAPES
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _jax_state(cfg):
    js, _ = _states(cfg)
    return js


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A float32/int32 train state written by JAX's store restores in the
    port bit for bit, into a template of the port's tensors; the port's
    manifest names the same leaves."""
    cfg = _smoke("tinyllama-1.1b")
    js = _jax_state(cfg)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, js)
    template = train_state(jax.tree_util.tree_map(np.zeros_like, js))
    assert tckpt.list_steps(str(tmp_path / "j")) == [7]
    back = tckpt.restore_checkpoint(str(tmp_path / "j"), 7, template)
    for got, want in zip(leaves(back), jax.tree_util.tree_leaves(js)):
        assert got.dtype == {np.dtype("float32"): torch.float32,
                             np.dtype("int32"): torch.int32}[want.dtype]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tckpt.save_checkpoint(str(tmp_path / "t"), 7, back)
    names = [json.load(open(tmp_path / d / "step_0000000007" /
                            "MANIFEST.json"))["leaves"] for d in "jt"]
    assert names[0] == names[1]
    assert "params/runs/0/wq" in names[1]
    assert names[1]["params/runs/0/wq"]["file"] == "params__runs__0__wq.npy"


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The reverse: the port's float32/int32 state restores in JAX's store
    bit for bit, into JAX's abstract template."""
    cfg = _smoke("gemma3-12b")
    js = _jax_state(cfg)
    ts = train_state(jax.tree_util.tree_map(np.asarray, js))
    ts["opt"]["step"] = torch.tensor(12, dtype=torch.int32)
    tckpt.save_checkpoint(str(tmp_path), 3, ts)
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js)
    back = jckpt.restore_checkpoint(str(tmp_path), 3, abstract)
    assert int(back["opt"]["step"]) == 12
    for got, want in zip(jax.tree_util.tree_leaves(back), leaves(ts)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_bf16_checkpoint_round_trip_and_store_semantics(tmp_path):
    """bf16 leaves are stored as their uint16 bits under the manifest dtype
    "bfloat16" and restore bit for bit (the reference's store cannot read
    its own bf16 leaves back: ROADMAP Queue 3); a restore casts to the
    template's dtype; ``keep`` prunes; a directory without a manifest is
    invisible and a stale ``.tmp`` is removed at the next commit; a leaf
    missing from the checkpoint or of another shape raises."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 3), generator=g).bfloat16(),
            "b": [torch.randn((4,), generator=g),
                  torch.arange(6, dtype=torch.int32)]}
    root = str(tmp_path)
    tckpt.save_checkpoint(root, 1, tree)
    man = json.load(open(tmp_path / "step_0000000001" / "MANIFEST.json"))
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_0000000001" / "w.npy").dtype == np.uint16
    back = tckpt.restore_checkpoint(root, 1, tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert torch.equal(back["b"][0], tree["b"][0])
    as_f32 = tckpt.restore_checkpoint(root, 1, dict(tree, w=tree["w"].float()))
    assert torch.equal(as_f32["w"], tree["w"].float())
    os.makedirs(tmp_path / "step_0000000099")
    os.makedirs(tmp_path / "step_0000000050.tmp")
    for s in (2, 3, 4):
        tckpt.save_checkpoint(root, s, tree, keep=2)
    assert tckpt.list_steps(root) == [3, 4]
    assert tckpt.latest_step(root) == 4
    assert not (tmp_path / "step_0000000050.tmp").exists()
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore_checkpoint(root, 4, dict(tree, extra=tree["w"]))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(root, 4, dict(tree, w=tree["w"][:2]))
    assert tckpt.latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# The fault-tolerant loop
# ---------------------------------------------------------------------------

_LOOP_CFG = dataclasses.replace(_smoke("tinyllama-1.1b"), n_layers=2,
                                block_pattern=("attn",) * 2)


def _loop_run(tmp, preempt=(), **kw):
    hyper = ttrain.TrainHyper(peak_lr=3e-3, warmup=2, total_steps=8)
    state = ttrain.init_train_state(torch.Generator().manual_seed(1),
                                    _LOOP_CFG, hyper)
    task = LMTask(vocab=_LOOP_CFG.vocab, seq_len=16, batch=2)
    loop = ttrain.TrainLoopConfig(total_steps=8, ckpt_dir=tmp, ckpt_every=4,
                                  log_every=1, preempt_at=preempt, **kw)
    return ttrain.run_training(state, ttrain.make_train_step(_LOOP_CFG,
                                                             hyper),
                               lambda s: lm_batches(task, s, device="cpu"),
                               loop)


def test_preemption_restart_is_bit_exact(tmp_path):
    """Preempted at step 6, resumed from the step-4 checkpoint: the final
    state equals an uninterrupted run's bit for bit (the batches are a pure
    function of the step), and a second call resumes from the final
    checkpoint without training."""
    crash, log = _loop_run(str(tmp_path / "a"), preempt=(6,))
    clean, clean_log = _loop_run(str(tmp_path / "b"))
    events = [m.get("event") for m in log if "event" in m]
    assert events == ["preempted", "resume"]
    assert [m for m in log if m.get("event") == "resume"][0]["step"] == 4
    for a, b in zip(leaves(crash), leaves(clean)):
        assert torch.equal(a, b)
    assert int(crash["opt"]["step"]) == 8
    losses = [m["loss"] for m in clean_log if "loss" in m]
    assert len(losses) == 8 and all(np.isfinite(losses))
    again, log2 = _loop_run(str(tmp_path / "b"))
    assert log2 == [{"event": "resume", "step": 8}]
    for a, b in zip(leaves(again), leaves(clean)):
        assert torch.equal(a, b)


def test_budget_deferral_on_jax_trace():
    """The store-and-execute gate on JAX's own rf trace (fed as
    ``budget_trace``): the same steps defer with the same stored energy as
    JAX's loop, and the schedule completes."""
    steps, cost = 30, 25.0
    trace = np.asarray(j_harvest_trace(jax.random.PRNGKey(0), steps + 1,
                                       "rf"))
    jloop = jtrain.TrainLoopConfig(total_steps=steps, budget_source="rf",
                                   budget_cost_uj=cost, log_every=1)
    _, jlog = jtrain.run_training(
        None, lambda s, b: (s, {"loss": jnp.float32(b)}), lambda s: s, jloop)
    tloop = ttrain.TrainLoopConfig(total_steps=steps, budget_source="rf",
                                   budget_cost_uj=cost, log_every=1)
    _, tlog = ttrain.run_training(
        None, lambda s, b: (s, {"loss": torch.tensor(float(b))}),
        lambda s: s, tloop, budget_trace=torch.as_tensor(trace))
    assert [m["step"] for m in tlog if m.get("deferred")] == [
        m["step"] for m in jlog if m.get("deferred")]
    _close([m["stored"] for m in tlog if m.get("deferred")],
           [m["stored"] for m in jlog if m.get("deferred")], rtol=0, atol=0)
    assert [m["step"] for m in tlog if "loss" in m] == [
        m["step"] for m in jlog if "loss" in m]
    assert any(m.get("deferred") for m in tlog)
    assert any("loss" in m for m in tlog)


def test_budget_from_the_ports_harvest_trace_defers(tmp_path):
    """With ``budget_source="rf"`` and no trace, the port draws its own
    from ``budget_seed``: some steps defer and the loop still ends its
    schedule."""
    _, log = _loop_run(None, budget_source="rf", budget_cost_uj=25.0)
    deferred = [m["step"] for m in log if m.get("deferred")]
    ran = [m["step"] for m in log if "loss" in m]
    assert deferred and ran
    assert sorted(deferred + ran) == list(range(8))


# ---------------------------------------------------------------------------
# Launcher, conversion, package boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--compress-grads"],
                                   ["--arch", "gemma3-12b",
                                    "--budget-source", "rf"]])
def test_train_launcher_runs_on_the_cpu(extra, tmp_path, capsys):
    state, log = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "4",
                               "--seq", "16", "--batch", "2", "--ckpt-dir",
                               str(tmp_path)] + extra)
    ran = [m for m in log if "loss" in m]
    assert ran and all(np.isfinite(m["loss"]) for m in ran)
    assert ("ef" in state) == ("--compress-grads" in extra)
    assert tckpt.latest_step(str(tmp_path)) == 4
    assert "'loss'" in capsys.readouterr().out


def test_train_launcher_refuses_what_waits_for_the_sharding_rules(
        monkeypatch):
    """``--smoke --multi-pod`` runs as the reference's smoke branch does
    (the flag ignored, one rank, the plain step); without ``--smoke`` a
    world that is neither one rank nor the production mesh's size raises
    ``ValueError`` naming both sizes, before anything is built; without a
    card the default device raises."""
    state, log = tlaunch.main(["--smoke", "--device", "cpu", "--multi-pod",
                               "--steps", "2", "--seq", "16", "--batch",
                               "2"])
    assert [m["step"] for m in log if "loss" in m] == [0, 1]
    assert int(state["opt"]["step"]) == 2
    with monkeypatch.context() as m:
        m.setattr(tlaunch, "_group", lambda dev: "WORLD")
        m.setattr(tlaunch, "_world_size", lambda group: 4)
        with pytest.raises(ValueError, match=r"\(16, 16\) holds 256 .* 4"):
            tlaunch.main(["--device", "cpu", "--steps", "1"])
        with pytest.raises(ValueError,
                           match=r"\(2, 16, 16\) holds 512 .* 4"):
            tlaunch.main(["--device", "cpu", "--multi-pod", "--compress-grads"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--smoke", "--steps", "1"])


def test_train_state_converts_and_comes_back():
    """``convert.train_state`` carries JAX's state (the bf16 moments of a
    ``moment_dtype=bfloat16`` config included) into the port, each leaf's
    dtype kept, and ``to_numpy`` carries it back."""
    cfg = _smoke("tinyllama-1.1b")
    jp, _ = _params(cfg)
    js = {"params": jp, "opt": joptim.adamw_init(
        jp, joptim.OptConfig(moment_dtype=jnp.bfloat16))}
    js["opt"]["m"] = jax.tree_util.tree_map(
        lambda p: (p * 0.5).astype(jnp.bfloat16), jp)
    ts = train_state(js)
    assert ts["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert ts["opt"]["step"].dtype == torch.int32 and ts["opt"]["step"].ndim == 0
    for got, want in zip(leaves(to_numpy(ts)), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32)
                                      if want.dtype == jnp.bfloat16
                                      else np.asarray(want))


def test_importing_the_training_port_leaves_jax_out():
    code = ("import sys; import repro_torch.train, repro_torch.optim, "
            "repro_torch.checkpoint, repro_torch.data.lm, "
            "repro_torch.core.compression, repro_torch.launch.train, "
            "repro_torch.launch.shapes, repro_torch.tree; "
            "repro_torch.launch.train.main(['--smoke', '--device', 'cpu', "
            "'--steps', '2', '--seq', '16', '--batch', '2']); "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.split()[-2:] == ["False", "False"]
