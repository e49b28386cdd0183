"""The port's churn, brown-out and intermittent lanes against the JAX
package, on the CPU: the staged HAR pass and its auxiliary heads, the
intermittent lane step, the alive traces and configs, and the scarce-harvest
fleet as a whole, ``repro_torch.seeker_fleet_simulate(alive=, brownout=,
intermittent=, aux_params=)`` against ``repro.serving.seeker_fleet_simulate``
at the real HAR widths.

The fleet gets the noise JAX drew, with each node's key frozen through the
slots JAX's engine did not run it (its emitted ``alive`` lane), and JAX's own
alive trace.  Integer traces and aggregates must be exactly equal, and the
run must contain dead slots, brown-outs, D6, D7 and D8.
"""
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.configs.seeker_har import HAR  # noqa: E402
from repro.core import fleet_harvest_traces  # noqa: E402
from repro.core.decision import (D6_PARTIAL, D7_EARLY_EXIT,  # noqa: E402
                                 D8_STAGED_FULL, IntermittentConfig)
from repro.core.energy import (BrownoutConfig, EnergyCosts,  # noqa: E402
                               PredictorState, fleet_alive_traces)
from repro.core.recovery import init_generator  # noqa: E402
from repro.data.sensors import class_signatures, har_stream  # noqa: E402
from repro.models import har as jhar  # noqa: E402
from repro.serving import edge_host as jeh  # noqa: E402
from repro.serving import (seeker_fleet_simulate,  # noqa: E402
                           wire_bytes_exact)

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.seeker_har import HAR as THAR  # noqa: E402
from repro_torch.core import decision as tdec  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.data import sensors as tsensors  # noqa: E402
from repro_torch.models import har as thar  # noqa: E402
from repro_torch.serving import edge_host as teh  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402
from repro_torch.serving import fleet_lanes  # noqa: E402

from test_torch_fleet import LOGIT_TOL, STORED_TOL, jax_fleet_noise  # noqa: E402

N, S = 8, 8
# benchmarks/fleet_scale.py: BROWNOUT_CFG, BROWNOUT_INITIAL_UJ,
# INTERMITTENT_SCARCITY (here the scarcest of a per-node spread up to 0.5,
# so the ladder's D2/D3 and brown-outs occur beside the lane's codes) and
# INTERMITTENT_CFG
BO = BrownoutConfig(off_uj=6.0, restart_uj=30.0)
CFG = IntermittentConfig(min_exit_stage=1, exit_threshold=0.0)
INITIAL_UJ = 12.0
SCARCITY = np.linspace(0.04, 0.5, N, dtype=np.float32)
CONF_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def model():
    key = jax.random.PRNGKey(0)
    params = jhar.har_init(key, HAR)
    aux = jhar.har_aux_init(jax.random.fold_in(key, 7), HAR)
    return params, aux


# ---------------------------------------------------------------------------
# Staged inference and the auxiliary heads
# ---------------------------------------------------------------------------

def _windows(seed, n):
    """HAR windows, the fleet's input: on them the quantized pass agrees
    with JAX's to the logit tolerance (ROADMAP Queue 3, the near-tie
    entry, shows a normal draw where one 12-bit logit does not)."""
    gen = torch.Generator().manual_seed(seed)
    return tsensors.har_stream(gen, n)[0].numpy()


def _assert_within_one_level(got, want, bits):
    """Quantized activations agree to one quantization level of each node's
    scale: the port's convolutions sum in another order than XLA's, and an
    element within an ulp of a rounding boundary moves a whole level
    (ROADMAP Queue 3, the near-tie entry)."""
    level = np.abs(want).max(axis=1, keepdims=True) / (2 ** (bits - 1) - 1)
    assert np.all(np.abs(got - want) <= 1.02 * level + 1e-6)


@pytest.mark.parametrize("bits", [16, 12])
def test_staged_is_bitwise_the_quantized_pass(model, bits):
    params = convert.har_params(model[0])
    x = _t(_windows(1, 6))
    np.testing.assert_array_equal(
        thar.har_apply_staged(params, x, bits, THAR).numpy(),
        thar.har_apply_quantized_nodes(thar.quantize_params(params, bits), x,
                                       bits).numpy())


@pytest.mark.parametrize("bits", [16, 12])
def test_stages_match_jax(model, bits):
    """Each stage on an (N, A) buffer equals the JAX stage on each node's
    (A,) buffer, chained from the window to the logits."""
    params = model[0]
    x = _windows(2, 12)
    qp_j = jhar.quantize_params(params, bits)
    qp_t = thar.quantize_params(convert.har_params(params), bits)
    a = jhar.har_act_buffer(HAR)
    assert thar.har_act_buffer(THAR) == a
    assert thar.har_stage_sizes(THAR) == jhar.har_stage_sizes(HAR)
    buf_j = jnp.pad(jnp.asarray(x).reshape(12, -1), ((0, 0), (0, a - 180)))
    buf_t = _t(buf_j)
    for stage in range(3):
        buf_j = jax.jit(jax.vmap(lambda b, st=stage: jhar.har_apply_stage(
            qp_j, b, st, HAR, bits)))(buf_j)
        buf_t = thar.har_apply_stage(qp_t, buf_t, stage, THAR, bits)
        if stage < 2:
            _assert_within_one_level(buf_t.numpy(), np.asarray(buf_j), bits)
    np.testing.assert_allclose(buf_t[:, :HAR.n_classes].numpy(),
                               np.asarray(buf_j)[:, :HAR.n_classes],
                               **LOGIT_TOL)


def test_aux_heads_match_jax(model):
    _, aux = model
    _, s1, s2, _ = jhar.har_stage_sizes(HAR)
    buf = np.random.default_rng(3).standard_normal(
        (6, jhar.har_act_buffer(HAR))).astype(np.float32)
    prog = np.array([1, 2, 1, 2, 2, 1], np.int32)
    want = jax.vmap(lambda b, p: jhar.har_apply_aux(aux, b, p, HAR, 16))(
        jnp.asarray(buf), jnp.asarray(prog))
    qa = thar.quantize_params(convert.aux_params(aux), 16)
    got = thar.har_apply_aux(qa, _t(buf), _t(prog), THAR)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    gen = torch.Generator().manual_seed(0)
    shapes = {k: tuple(v.shape) for k, v in thar.har_aux_init(gen,
                                                               THAR).items()}
    assert shapes == {k: v.shape for k, v in aux.items()}


# ---------------------------------------------------------------------------
# The intermittent lane step
# ---------------------------------------------------------------------------

def test_intermittent_lane_step_matches_jax(model):
    """A batch of nodes in every lane situation (idle and deferred, in
    flight at each stage, broke, rich) against the JAX lane vmapped."""
    params, aux = model
    n = 12
    rng = np.random.default_rng(5)
    win = _windows(4, n)
    stored = np.array([0.3, 2, 8, 12, 16.5, 20, 25, 30, 40, 9, 14, 35],
                      np.float32)
    harv = rng.uniform(0.0, 1.0, n).astype(np.float32)
    ladder = np.array([5, 5, 5, 2, 5, 3, 5, 5, 4, 5, 0, 5], np.int32)
    active = np.array([0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0], bool)
    stage = np.where(active, [0, 0, 1, 2, 0, 1, 3, 0, 2, 1, 0, 0], 0)
    a = jhar.har_act_buffer(HAR)
    acts = np.zeros((n, a), np.float32)
    acts[:, :180] = win.reshape(n, -1)
    qp_j = jhar.quantize_params(params, 16)
    for i in np.nonzero(active)[0]:          # a real suspended activation
        buf = jnp.asarray(acts[i])
        for st in range(stage[i]):
            buf = jhar.har_apply_stage(qp_j, buf, st, HAR, 16)
        acts[i] = np.asarray(buf)
    src = rng.integers(0, 4, n).astype(np.int32)
    state_j = jeh.SeekerNodeState(
        stored_uj=jnp.asarray(stored),
        predictor=PredictorState(jnp.zeros((n, 8)),
                                 jnp.zeros((n,), jnp.int32)),
        prev_label=jnp.arange(n, dtype=jnp.int32) % 12)
    it_j = jeh.IntermittentState(jnp.asarray(active),
                                 jnp.asarray(stage, jnp.int32),
                                 jnp.asarray(acts), jnp.asarray(src))
    want = jax.jit(jax.vmap(lambda w, st, h, d, it: jeh.intermittent_lane_step(
        w, st, h, d, it, jnp.int32(7), qp=qp_j, aux_params=aux, har_cfg=HAR,
        costs=EnergyCosts(), quant_bits=16, cfg=CFG, reserve_uj=6.0)))(
        jnp.asarray(win), state_j, jnp.asarray(harv), jnp.asarray(ladder),
        it_j)
    got = teh.intermittent_lane_step(
        _t(win), convert.node_state(state_j), _t(harv), _t(ladder),
        convert.intermittent_state(it_j), 7,
        qp=thar.quantize_params(convert.har_params(params), 16),
        qa=thar.quantize_params(convert.aux_params(aux), 16), har_cfg=THAR,
        costs=tenergy.EnergyCosts(), quant_bits=16,
        cfg=tdec.IntermittentConfig(1, 0.0), reserve_uj=6.0)
    for name in ("engaged", "decision", "emit", "emit_src", "emit_stage",
                 "prev_label"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    emitted = np.asarray(want.emit) > 0
    np.testing.assert_array_equal(got.emit_label.numpy()[emitted],
                                  np.asarray(want.emit_label)[emitted])
    for name in ("spend", "payload_bytes", "stored_uj"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   **STORED_TOL, err_msg=name)
    np.testing.assert_allclose(got.emit_conf.numpy(),
                               np.asarray(want.emit_conf), **CONF_TOL)
    for name in ("active", "stage", "src_slot"):
        np.testing.assert_array_equal(getattr(got.state, name).numpy(),
                                      np.asarray(getattr(want.state, name)),
                                      err_msg=name)
    _assert_within_one_level(got.state.acts.numpy(),
                             np.asarray(want.state.acts), 16)
    # the batch covers the lane's outcomes
    assert {5, 6, 7, 8} <= set(np.asarray(want.decision).tolist())


# ---------------------------------------------------------------------------
# Alive traces and configs
# ---------------------------------------------------------------------------

def test_alive_traces_shape_and_all_true_case():
    gen = torch.Generator().manual_seed(0)
    tr = tenergy.fleet_alive_traces(gen, 64, 32)
    assert tr.shape == (64, 32) and tr.dtype == torch.bool
    assert bool(tenergy.fleet_alive_traces(gen, 5, 9, duty=1.0,
                                           p_glitch=0.0).all())
    phases = tenergy.fleet_phase_offsets(gen, 200, period=16)
    assert phases.dtype == torch.int32
    assert int(phases.min()) >= 0 and int(phases.max()) < 16
    with pytest.raises(ValueError, match="duty"):
        tenergy.fleet_alive_traces(gen, 2, 2, duty=1.5)


def test_alive_traces_match_jax_in_distribution():
    """Duty 0.75 with 5% glitches: both packages' up-fraction sits at
    0.75 * 0.95, well inside sampling noise at 400 x 64 draws."""
    gen = torch.Generator().manual_seed(1)
    port = float(tenergy.fleet_alive_traces(gen, 400, 64).float().mean())
    ref = float(jnp.mean(fleet_alive_traces(jax.random.PRNGKey(1), 400, 64)))
    assert abs(port - 0.7125) < 0.02 and abs(ref - 0.7125) < 0.02


def test_configs_validate_like_jax():
    assert tenergy.BrownoutConfig() == tenergy.BrownoutConfig(5.0, 25.0)
    assert (tdec.IntermittentConfig().min_exit_stage,
            tdec.IntermittentConfig().exit_threshold) == (1, 0.0)
    assert tdec.N_INTERMITTENT_DECISIONS == 9
    with pytest.raises(ValueError):
        tenergy.BrownoutConfig(off_uj=10.0, restart_uj=5.0)
    with pytest.raises(ValueError):
        tdec.IntermittentConfig(min_exit_stage=3)
    with pytest.raises(ValueError):
        tdec.IntermittentConfig(exit_threshold=-0.1)


# ---------------------------------------------------------------------------
# The scarce-harvest fleet against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scarce(model):
    params, aux = model
    key = jax.random.PRNGKey(0)
    gen = init_generator(key, HAR.window, HAR.channels)
    stream = jax.jit(har_stream, static_argnums=1)
    per_node = [stream(jax.random.fold_in(key, 100 + i), S)
                for i in range(N)]
    wins = np.asarray(jnp.stack([w for w, _ in per_node]))      # (N, S, T, C)
    labels = np.asarray(jnp.stack([lab for _, lab in per_node]).T)  # (S, N)
    harvest = np.asarray(fleet_harvest_traces(key, N, S)) * SCARCITY[:, None]
    alive = np.asarray(fleet_alive_traces(jax.random.fold_in(key, 3), N, S,
                                          duty=0.75, period=8, p_glitch=0.1))
    sigs = class_signatures()
    ref = seeker_fleet_simulate(
        wins, harvest, signatures=sigs, qdnn_params=params,
        host_params=params, gen_params=gen, har_cfg=HAR, key=key,
        labels=labels, alive=alive, brownout=BO, initial_uj=INITIAL_UJ,
        intermittent=CFG, aux_params=aux)
    noise = jax_fleet_noise(key, N, S, HAR.window, HAR.channels,
                            alive=np.asarray(ref["alive"]))
    port = dict(signatures=convert.tensor(sigs),
                qdnn_params=convert.har_params(params),
                host_params=convert.har_params(params),
                gen_params=convert.generator_params(gen), har_cfg=THAR,
                labels=labels, initial_uj=INITIAL_UJ,
                brownout=tenergy.BrownoutConfig(6.0, 30.0),
                intermittent=tdec.IntermittentConfig(1, 0.0),
                aux_params=convert.aux_params(aux), device="cpu")
    res = repro_torch.seeker_fleet_simulate(wins, harvest, alive=alive,
                                            noise=noise, **port)
    return dict(ref=ref, res=res, wins=wins, harvest=harvest, alive=alive,
                noise=noise, port=port)


def test_scarce_fleet_exercises_every_lane(scarce):
    """The parity below proves something only if the run has dead slots,
    brown-outs and every code of the intermittent lane."""
    ref = scarce["ref"]
    hist = np.asarray(ref["decision_histogram"])
    assert int((~scarce["alive"]).sum()) > 0
    assert int(ref["brownout_events"]) > 0 and int(ref["brownout_slots"]) > 0
    assert hist[D6_PARTIAL] > 0 and hist[D7_EARLY_EXIT] > 0
    assert hist[D8_STAGED_FULL] > 0
    assert int(ref["it_full"]) > 0 and int(ref["it_early"]) > 0


@pytest.mark.parametrize("name", [
    "decisions", "payload_bytes", "k_trace", "alive", "brownout", "preds",
    "it_emit", "it_src", "it_stage", "decision_histogram", "completed",
    "alive_slots", "brownout_slots", "brownout_events", "it_full",
    "it_early", "correct", "correct_ladder", "it_correct_full",
    "it_correct_early", "final_brownout"])
def test_scarce_fleet_integer_outputs_equal_jax(scarce, name):
    np.testing.assert_array_equal(scarce["res"][name].numpy(),
                                  np.asarray(scarce["ref"][name]))


def test_scarce_fleet_floats_and_lane_state_match_jax(scarce):
    ref, res = scarce["ref"], scarce["res"]
    assert tfleet.wire_bytes_exact(res) == wire_bytes_exact(ref)
    emitted = np.asarray(ref["it_emit"]) > 0
    np.testing.assert_array_equal(res["it_label"].numpy()[emitted],
                                  np.asarray(ref["it_label"])[emitted])
    np.testing.assert_allclose(res["it_conf"].numpy()[emitted],
                               np.asarray(ref["it_conf"])[emitted],
                               **CONF_TOL)
    np.testing.assert_allclose(res["stored_uj"].numpy(),
                               np.asarray(ref["stored_uj"]), **STORED_TOL)
    np.testing.assert_allclose(res["logits"].numpy(),
                               np.asarray(ref["logits"]), **LOGIT_TOL)
    for name in ("completed_frac", "fleet_accuracy"):
        np.testing.assert_allclose(float(res[name]), float(ref[name]),
                                   rtol=1e-6, err_msg=name)
    fi_r, fi_p = ref["final_intermittent"], res["final_intermittent"]
    for name in ("active", "stage", "src_slot"):
        np.testing.assert_array_equal(getattr(fi_p, name).numpy(),
                                      np.asarray(getattr(fi_r, name)))
    _assert_within_one_level(fi_p.acts.numpy(), np.asarray(fi_r.acts), 16)


def test_scarce_fleet_resumes_and_blocks_like_one_run(scarce):
    """A run split in two through the resume contract (state0,
    brownout_state0, intermittent_state0, slot0), and a run in node blocks,
    equal the one full run."""
    d, full = scarce, scarce["res"]
    half = S // 2

    def part(sl, **kw):
        return repro_torch.seeker_fleet_simulate(
            d["wins"][:, sl], d["harvest"][:, sl], alive=d["alive"][:, sl],
            noise={k: v[sl] for k, v in d["noise"].items()},
            **dict(d["port"], labels=d["port"]["labels"][sl], **kw))

    first = part(slice(0, half))
    second = part(slice(half, S), state0=first["final_state"],
                  brownout_state0=first["final_brownout"],
                  intermittent_state0=first["final_intermittent"],
                  slot0=half)
    for name in ("decisions", "it_emit", "it_src", "brownout", "stored_uj"):
        np.testing.assert_array_equal(
            np.concatenate([first[name], second[name]]), full[name].numpy(),
            err_msg=name)
    blocked = part(slice(0, S), node_block=3)
    for name in ("decisions", "it_emit", "brownout", "stored_uj", "logits"):
        np.testing.assert_array_equal(blocked[name].numpy(),
                                      full[name].numpy(), err_msg=name)


def test_all_true_alive_and_no_lanes_is_the_bare_engine(scarce):
    d = scarce
    port = {k: v for k, v in d["port"].items()
            if k not in ("brownout", "intermittent", "aux_params")}
    bare = repro_torch.seeker_fleet_simulate(d["wins"], d["harvest"],
                                             noise=d["noise"], **port)
    on = repro_torch.seeker_fleet_simulate(
        d["wins"], d["harvest"], noise=d["noise"],
        alive=np.ones((N, S), bool), **port)
    for name in ("decisions", "payload_bytes", "stored_uj", "logits"):
        np.testing.assert_array_equal(on[name].numpy(), bare[name].numpy())
    assert int(bare["brownout_events"]) == 0
    assert not bool(bare["brownout"].any())


def test_lane_registry_names_the_results(scarce):
    """Every lane this run turns on has its traces, aggregates and resume
    results in the run, every registered lane's engine arguments and
    initializer exist, and a lane that carries state has a FleetCarry
    field."""
    res = scarce["res"]
    params = inspect.signature(repro_torch.seeker_fleet_simulate).parameters
    names = [ln.name for ln in fleet_lanes.FLEET_LANES]
    assert names == ["node", "prng", "churn", "brownout", "intermittent",
                     "telemetry", "task"]
    on = frozenset({"brownout", "intermittent"})
    for ln in fleet_lanes.FLEET_LANES:
        for key in ((ln.trace_keys + ln.aggregates + ln.resume_out)
                    if ln.active(on) else ()):
            assert key in res, (ln.name, key)
        assert set(ln.counter_keys) <= set(ln.aggregates)
        assert set(ln.resume_in) | {ln.config_kwarg} - {None} <= set(params)
        module, attr = ln.init.split(":")
        assert callable(getattr(importlib.import_module(module), attr))
        assert ln.carry_field in fleet_lanes.FleetCarry._fields + (None,)
    active = frozenset({"brownout", "intermittent"})
    assert fleet_lanes.fleet_trace_keys(active)[-1] == "it_stage"
    assert "it_emit" not in fleet_lanes.fleet_trace_keys(frozenset())
    with pytest.raises(ValueError, match="freeze"):
        fleet_lanes.FleetLane("x", "", None, None, "m:f", "thaw", (), (), (),
                              (), ())


def test_seeker_simulate_runs_the_lanes_on_sensor_zero(scarce, model):
    """The N=3 wrapper threads brown-out and the intermittent lane through
    to the fleet engine and reports sensor 0's lane traces."""
    d = scarce
    port = {k: v for k, v in d["port"].items()
            if k not in ("labels", "initial_uj")}
    noise = {k: v[:, :3] for k, v in d["noise"].items()}
    harvest = d["harvest"][0]
    sim = repro_torch.seeker_simulate(d["wins"][0], d["port"]["labels"][:, 0],
                                      harvest, noise=noise, **port)
    fleet = repro_torch.seeker_fleet_simulate(
        d["wins"][0], np.broadcast_to(harvest, (3, S)), noise=noise, **port)
    for name in ("decisions", "it_emit", "it_stage", "brownout"):
        np.testing.assert_array_equal(sim[name].numpy(),
                                      fleet[name][:, 0].numpy())
    assert int(sim["it_full"]) == int(fleet["it_full"])
    completed = ~np.isin(sim["decisions"].numpy(), (5, D6_PARTIAL))
    np.testing.assert_allclose(float(sim["completed_frac"]),
                               completed.mean(), rtol=1e-6)
    one = teh.intermittent_node_init(THAR)
    ref = jeh.intermittent_node_init(HAR)
    assert [tuple(x.shape) for x in one] == [x.shape for x in ref]


def test_half_configured_intermittent_runs_raise(scarce):
    d = scarce
    port = {k: v for k, v in d["port"].items() if k != "aux_params"}
    with pytest.raises(ValueError, match="aux_params"):
        repro_torch.seeker_fleet_simulate(d["wins"], d["harvest"],
                                          noise=d["noise"], **port)
    port = {k: v for k, v in d["port"].items() if k != "intermittent"}
    with pytest.raises(ValueError, match="intermittent_state0"):
        repro_torch.seeker_fleet_simulate(
            d["wins"], d["harvest"], noise=d["noise"],
            intermittent_state0=teh.intermittent_fleet_init(N, THAR), **port)
