"""The paper's per-sensor path in ``repro_torch`` against ``repro``, on the
same numpy inputs, on the CPU (the kernels run as their plain versions):
the configs, the HAR CNN at the bearing width, ``memo_decision``,
``seeker_sensor_step``, the single-cloud ``kmeans_coreset``,
``topk_importance_coreset``, the discriminator and the per-sensor oracle
``seeker_simulate_reference``.

Randomness is drawn with ``jax.random`` from the keys the JAX functions
use and handed to the port as tensors: D4's uniforms (coreset.py:230) for
the sensor step, and ``jax_fleet_noise`` for the oracle, whose per-sensor
keys ``fold_in(key, i)`` and 3-way split per slot (edge_host.py:505,510)
are the fleet engine's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.configs import seeker_har as jcfg  # noqa: E402
from repro.core import coreset as jcs  # noqa: E402
from repro.core import energy as jen  # noqa: E402
from repro.core import memo as jmemo  # noqa: E402
from repro.core import recovery as jrec  # noqa: E402
from repro.core.aac import make_aac_table  # noqa: E402
from repro.data.sensors import class_signatures, har_stream  # noqa: E402
from repro.models import har as jhar  # noqa: E402
from repro.serving import edge_host as jeh  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import seeker_har as tcfg  # noqa: E402
from repro_torch.core import coreset as tcs  # noqa: E402
from repro_torch.core import energy as ten  # noqa: E402
from repro_torch.core import memo as tmemo  # noqa: E402
from repro_torch.core import recovery as trec  # noqa: E402
from repro_torch.core.decision import (D0_MEMO, D2_DNN_QUANT,  # noqa: E402
                                       D3_CLUSTER, D4_SAMPLING, DEFER)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import har as thar  # noqa: E402
from repro_torch.serving import edge_host as teh  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402

from test_torch_fleet import jax_fleet_noise  # noqa: E402

FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)    # float32 reductions in another order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STORED_TOL = dict(rtol=0, atol=1e-4)
S_ORACLE, N_SENSORS = 8, 3


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# configs and the HAR CNN at the bearing width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["HAR", "PAMAP2", "BEARING"])
def test_configs_equal_jax(name):
    assert (dataclasses.asdict(getattr(tcfg, name))
            == dataclasses.asdict(getattr(jcfg, name)))


def test_bearing_config_is_the_paper_width():
    cfg = tcfg.BEARING
    assert (cfg.window, cfg.channels, cfg.n_classes, cfg.kernel) == (120, 1,
                                                                      10, 7)
    assert tcfg.SYSTEM.bearing_clusters == 18


@pytest.fixture(scope="module")
def bearing_model():
    params = jhar.har_init(jax.random.PRNGKey(1), jcfg.BEARING)
    x = (_rng(1).standard_normal((6, 120, 1))
         * np.linspace(0.5, 3.0, 6)[:, None, None]).astype(np.float32)
    return params, convert.har_params(params), x


def test_har_apply_matches_jax_at_bearing_width(bearing_model):
    params, tparams, x = bearing_model
    want = np.asarray(jax.jit(jhar.har_apply)(params, x))
    got = _np(thar.har_apply(tparams, _t(x)))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_har_apply_quantized_matches_jax_at_bearing_width(bearing_model):
    params, tparams, x = bearing_model
    want = np.asarray(jax.jit(jhar.har_apply_quantized, static_argnums=2)(
        params, x, 16))
    got = _np(thar.har_apply_quantized(tparams, _t(x), 16))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# memo_decision
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def memo_inputs():
    sigs = np.asarray(class_signatures())                     # (12, 60, 3)
    wins = _rng(2).standard_normal((6, 60, 3)).astype(np.float32)
    wins[1] = sigs[3]                                         # an exact hit
    wins[4] = sigs[7] + 0.05 * wins[4]                        # a near one
    return sigs, wins


def _memo_equal(got, want):
    assert bool(got.hit) == bool(want.hit)
    assert int(got.label) == int(want.label)
    np.testing.assert_allclose(_np(got.max_corr), np.asarray(want.max_corr),
                               **FLOAT_TOL)


@pytest.mark.parametrize("i", range(6))
def test_memo_decision_single_window_matches_jax(memo_inputs, i):
    sigs, wins = memo_inputs
    want = jmemo.memo_decision(wins[i], sigs)
    got = tmemo.memo_decision(_t(wins[i]), _t(sigs))
    assert got.label.dtype == torch.int32 and got.hit.shape == ()
    _memo_equal(got, want)


def test_memo_decision_batch_is_the_window_loop(memo_inputs):
    sigs, wins = memo_inputs
    got = tmemo.memo_decision(_t(wins), _t(sigs))
    assert got.hit.shape == (6,)
    for i in range(6):
        _memo_equal(tmemo.MemoResult(*(x[i] for x in got)),
                    jmemo.memo_decision(wins[i], sigs))
    # the exact hit and the noisy copy clear the threshold with their label
    assert got.hit.tolist()[1] and got.label.tolist()[1] == 3
    assert got.hit.tolist()[4] and got.label.tolist()[4] == 7
    assert not got.hit.tolist()[0]


def test_memo_decision_ties_go_to_the_lower_signature(memo_inputs):
    sigs, _ = memo_inputs
    bank = np.stack([sigs[5], sigs[2], sigs[2]])
    want = jmemo.memo_decision(sigs[2], bank)
    got = tmemo.memo_decision(_t(sigs[2]), _t(bank))
    assert int(want.label) == 1
    _memo_equal(got, want)


# ---------------------------------------------------------------------------
# seeker_sensor_step at HAR width, N nodes against a loop of JAX's step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sensor_step():
    key = jax.random.PRNGKey(3)
    cfg = jcfg.HAR
    params = jhar.har_init(key, cfg)
    sigs = np.asarray(class_signatures())
    wins = np.array(har_stream(key, 4)[0])                    # (4, 60, 3)
    wins[2] = sigs[5]                                         # a memo hit
    stored = np.asarray([50.0, 4.0, 30.0, 150.0], np.float32)
    harvest = np.asarray([6.0, 0.2, 3.0, 40.0], np.float32)
    aac = make_aac_table(_rng(3).uniform(0.6, 0.9, (cfg.n_classes, 4)),
                         [4, 6, 8, 12])
    keys = [jax.random.fold_in(key, i) for i in range(4)]
    # compiled, as the JAX engines run it (ROADMAP Queue 3: the quantizer's
    # scale depends on how JAX runs)
    step = jax.jit(functools.partial(
        jeh.seeker_sensor_step, signatures=sigs, qdnn_params=params,
        har_cfg=cfg, aac_table=aac, costs=jen.EnergyCosts()))
    want = []
    for i in range(4):
        st = jeh.seeker_node_init()._replace(stored_uj=jnp.float32(stored[i]),
                                              prev_label=jnp.int32(i))
        want.append(step(wins[i], st, jnp.float32(harvest[i]), key=keys[i]))
    u = np.stack([np.asarray(jax.random.uniform(k, (cfg.window,),
                                                minval=1e-9, maxval=1.0))
                  for k in keys])
    st0 = tfleet.fleet_node_init(4, device="cpu")._replace(
        stored_uj=_t(stored), prev_label=torch.arange(4, dtype=torch.int32))
    got = teh.seeker_sensor_step(
        _t(wins), st0, _t(harvest), _t(u), signatures=_t(sigs),
        qp=thar.quantize_params(convert.har_params(params), 16),
        aac_table=convert.aac_table(aac), costs=ten.EnergyCosts())
    return got, want


def _stack(want, field):
    return np.stack([np.asarray(getattr(w, field)) for w in want])


def test_sensor_step_runs_several_branches(sensor_step):
    got, want = sensor_step
    codes = set(_np(got.decision).tolist())
    assert {D0_MEMO, D2_DNN_QUANT} <= codes and len(codes) >= 3, codes


@pytest.mark.parametrize("field", ["decision", "label_or_neg", "coreset_k",
                                   "coreset_counts", "samp_idx",
                                   "payload_bytes"])
def test_sensor_step_integer_fields_equal_jax(sensor_step, field):
    got, want = sensor_step
    np.testing.assert_array_equal(_np(getattr(got, field)),
                                  _stack(want, field))


@pytest.mark.parametrize("field", ["coreset_centers", "coreset_radii",
                                   "samp_vals", "samp_mean", "samp_var",
                                   "logits"])
def test_sensor_step_float_fields_match_jax(sensor_step, field):
    got, want = sensor_step
    np.testing.assert_allclose(_np(getattr(got, field)), _stack(want, field),
                               **FLOAT_TOL)


def test_sensor_step_state_matches_jax(sensor_step):
    got, want = sensor_step
    np.testing.assert_allclose(_np(got.state.stored_uj),
                               [float(w.state.stored_uj) for w in want],
                               **FLOAT_TOL)
    np.testing.assert_array_equal(_np(got.state.prev_label),
                                  [int(w.state.prev_label) for w in want])
    np.testing.assert_allclose(
        _np(got.state.predictor.history),
        np.stack([np.asarray(w.state.predictor.history) for w in want]),
        **FLOAT_TOL)


# ---------------------------------------------------------------------------
# single-cloud k-means and the deterministic top-m sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k", [(60, 12), (120, 18)])
def test_kmeans_init_centers_match_jax(t, k):
    pts = _rng(t).standard_normal((t, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tref.kmeans_init_centers(_t(pts), k)),
        np.asarray(jcs._init_centers(jnp.asarray(pts), k)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("t,k", [(60, 12), (120, 18)])
def test_single_cloud_kmeans_matches_jax(t, k, seed):
    col = (_rng(10 * t + seed).standard_normal((t, 1))
           + np.sin(np.linspace(0, 8, t))[:, None]).astype(np.float32)
    pts = np.asarray(jcs.points_from_window(jnp.asarray(col)))  # (T, 2)
    want = jcs.kmeans_coreset(jnp.asarray(pts), k)
    got = tcs.kmeans_coreset(_t(pts), k)
    assert got.counts.dtype == torch.int32 and got.centers.shape == (k, 2)
    np.testing.assert_array_equal(_np(got.counts), np.asarray(want.counts))
    np.testing.assert_allclose(_np(got.centers), np.asarray(want.centers),
                               **FLOAT_TOL)
    np.testing.assert_allclose(_np(got.radii), np.asarray(want.radii),
                               **FLOAT_TOL)


def _topk_windows():
    r = _rng(4)
    return {"har": r.standard_normal((60, 3)).astype(np.float32),
            "har_trend": (r.standard_normal((60, 3)) + np.linspace(
                0, 3, 60)[:, None]).astype(np.float32),
            "bearing": r.standard_normal((120, 1)).astype(np.float32),
            "flat": np.ones((60, 3), np.float32)}


@pytest.mark.parametrize("m", [8, 20])
@pytest.mark.parametrize("case", ["har", "har_trend", "bearing", "flat"])
def test_topk_importance_coreset_matches_jax(case, m):
    win = _topk_windows()[case]
    want = jcs.topk_importance_coreset(jnp.asarray(win), m)
    got = tcs.topk_importance_coreset(_t(win), m)
    np.testing.assert_array_equal(_np(got.indices), np.asarray(want.indices))
    for f in ("values", "weights", "mean", "var"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **FLOAT_TOL)


def test_topk_flat_window_keeps_the_lowest_indices():
    got = tcs.topk_importance_coreset(torch.ones((60, 3)), 20)
    assert got.indices.tolist() == list(range(20))


def test_topk_importance_coreset_batch_is_the_window_loop():
    wins = np.stack([w for name, w in _topk_windows().items()
                     if name != "bearing"])
    got = tcs.topk_importance_coreset(_t(wins), 20)
    for i, win in enumerate(wins):
        one = tcs.topk_importance_coreset(_t(win), 20)
        for a, b in zip(got, one):
            torch.testing.assert_close(a[i], b)


# ---------------------------------------------------------------------------
# the discriminator
# ---------------------------------------------------------------------------

def test_init_discriminator_shapes_match_jax():
    want = jrec.init_discriminator(jax.random.PRNGKey(0), 60, 3)
    got = trec.init_discriminator(torch.Generator().manual_seed(0), 60, 3)
    for f in trec.DiscriminatorParams._fields:
        assert tuple(getattr(got, f).shape) == getattr(want, f).shape, f


@pytest.mark.parametrize("t,c", [(60, 3), (120, 1)])
def test_discriminator_apply_matches_jax(t, c):
    params = jrec.init_discriminator(jax.random.PRNGKey(t), t, c)
    x = _rng(t).standard_normal((5, t, c)).astype(np.float32)
    want = np.asarray(jrec.discriminator_apply(params, x))
    got = trec.discriminator_apply(convert.discriminator_params(params), _t(x))
    assert got.shape == (5,)
    np.testing.assert_allclose(_np(got), want, **FLOAT_TOL)
    # one window without a batch axis gives a scalar score
    one = trec.discriminator_apply(convert.discriminator_params(params),
                                   _t(x[0]))
    assert one.shape == () and abs(float(one) - want[0]) <= 1e-5


# ---------------------------------------------------------------------------
# the per-sensor oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle():
    key = jax.random.PRNGKey(0)
    cfg = jcfg.HAR
    params = jhar.har_init(key, cfg)
    gen = jrec.init_generator(key, cfg.window, cfg.channels)
    sigs = class_signatures()
    wins, labels = har_stream(key, S_ORACLE)
    wins = wins.at[6].set(sigs[3])
    harvest = jen.harvest_trace(key, S_ORACLE, "piezo")
    ref = jeh.seeker_simulate_reference(
        wins, labels, harvest, signatures=sigs, qdnn_params=params,
        host_params=params, gen_params=gen, har_cfg=cfg,
        n_sensors=N_SENSORS, key=key)
    port = dict(signatures=convert.tensor(sigs),
                qdnn_params=convert.har_params(params),
                host_params=convert.har_params(params),
                gen_params=convert.generator_params(gen),
                har_cfg=tcfg.HAR, n_sensors=N_SENSORS, device="cpu")
    noise = jax_fleet_noise(key, N_SENSORS, S_ORACLE, cfg.window,
                            cfg.channels)
    args = (np.asarray(wins), np.asarray(labels), np.asarray(harvest))
    res = repro_torch.seeker_simulate_reference(*args, noise=noise, **port)
    return ref, res, args, port, noise


def test_oracle_run_holds_every_ladder_decision(oracle):
    ref, res, *_ = oracle
    codes = set(np.asarray(ref["decisions"]).tolist())
    assert {D0_MEMO, D2_DNN_QUANT, D3_CLUSTER, D4_SAMPLING, DEFER} <= codes


@pytest.mark.parametrize("name", ["decisions", "k_trace", "payload_bytes",
                                  "preds", "labels"])
def test_oracle_integer_traces_equal_jax(oracle, name):
    ref, res, *_ = oracle
    np.testing.assert_array_equal(_np(res[name]), np.asarray(ref[name]))


@pytest.mark.parametrize("name", ["accuracy_completed", "accuracy_scheduled",
                                  "completed_frac", "raw_bytes"])
def test_oracle_scores_equal_jax(oracle, name):
    ref, res, *_ = oracle
    np.testing.assert_allclose(_np(res[name]), np.asarray(ref[name]),
                               rtol=1e-6)


def test_oracle_stored_energy_matches_jax(oracle):
    ref, res, *_ = oracle
    np.testing.assert_allclose(_np(res["stored_uj"]),
                               np.asarray(ref["stored_uj"]), **STORED_TOL)


@pytest.fixture(scope="module")
def port_fleet(oracle):
    _, res, args, port, noise = oracle
    return res, repro_torch.seeker_simulate(*args, noise=noise, **port)


@pytest.mark.parametrize("name", ["decisions", "k_trace", "payload_bytes",
                                  "preds", "stored_uj", "completed_frac",
                                  "accuracy_completed", "raw_bytes"])
def test_oracle_is_bitwise_the_port_fleet(port_fleet, name):
    res, fleet = port_fleet
    assert torch.equal(res[name], fleet[name]), name


def test_oracle_with_a_generator_sees_the_fleet_noise(oracle):
    _, _, args, port, _ = oracle
    args = tuple(a[:3] for a in args)
    a = repro_torch.seeker_simulate_reference(
        *args, generator=torch.Generator().manual_seed(7), **port)
    b = repro_torch.seeker_simulate(
        *args, generator=torch.Generator().manual_seed(7), **port)
    for name in ("decisions", "k_trace", "payload_bytes", "preds",
                 "stored_uj"):
        assert torch.equal(a[name], b[name]), name


def test_oracle_refuses_noise_of_another_shape(oracle):
    _, _, args, port, noise = oracle
    bad = dict(noise, u=noise["u"][:, :2])
    with pytest.raises(ValueError, match="noise"):
        repro_torch.seeker_simulate_reference(*args, noise=bad, **port)
