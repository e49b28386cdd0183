"""``repro_torch.core`` against ``repro.core``, function by function, on the
same numpy inputs.  Randomness is drawn with ``jax.random`` from the keys
and split discipline the JAX functions use (coreset.py:230,
recovery.py:56-59,96,167) and handed to the port as tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.core import aac as jaac  # noqa: E402
from repro.core import coreset as jcs  # noqa: E402
from repro.core import decision as jdec  # noqa: E402
from repro.core import energy as jen  # noqa: E402
from repro.core import memo as jmemo  # noqa: E402
from repro.core import recovery as jrec  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import aac as tac  # noqa: E402
from repro_torch.core import coreset as tcs  # noqa: E402
from repro_torch.core import decision as tdec  # noqa: E402
from repro_torch.core import energy as ten  # noqa: E402
from repro_torch.core import memo as tmemo  # noqa: E402
from repro_torch.core import recovery as trec  # noqa: E402

T, C = 60, 3
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)    # float32 reductions in another order


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def windows():
    return (_rng(0).standard_normal((5, T, C))
            + np.sin(np.linspace(0, 6, T))[None, :, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# energy and decision
# ---------------------------------------------------------------------------

def _budgets(seed, n=600):
    """Random stored/forecast/harvest values, a third of them placed exactly
    on a rung of the cost ladder."""
    r = _rng(seed)
    costs = np.asarray(jen.EnergyCosts().decision_costs()[:6], np.float32)
    stored = r.uniform(0, 40, n).astype(np.float32)
    forecast = r.uniform(0, 10, n).astype(np.float32)
    on_rung = r.random(n) < 0.33
    stored[on_rung] = costs[r.integers(0, 6, n)][on_rung]
    forecast[on_rung] = 0.0
    corr = r.uniform(0.8, 1.0, n).astype(np.float32)
    corr[:20] = np.float32(0.95)
    return corr, stored, forecast


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("allow_full_dnn", [False, True])
def test_choose_decision_matches_jax(strict, allow_full_dnn):
    corr, stored, forecast = _budgets(1)
    harvested = (_rng(2).uniform(0, 5, corr.shape).astype(np.float32)
                 if strict else None)
    costs = jen.EnergyCosts()
    ref = jdec.choose_decision(corr, stored, forecast, costs,
                               allow_full_dnn=allow_full_dnn,
                               harvested_uj=harvested)
    got = tdec.choose_decision(
        _t(corr), _t(stored), _t(forecast), ten.EnergyCosts(),
        allow_full_dnn=allow_full_dnn,
        harvested_uj=None if harvested is None else _t(harvested))
    np.testing.assert_array_equal(got.decision.numpy(),
                                  np.asarray(ref.decision))
    np.testing.assert_array_equal(got.spend.numpy(), np.asarray(ref.spend))
    assert got.decision.dtype == torch.int32
    assert len(set(got.decision.tolist())) >= 4


@pytest.mark.parametrize("strict", [False, True])
def test_choose_decision_cost_scale_matches_jax(strict):
    """Per node, ``cost * cost_scale`` is one float32 row of the table: the
    decisions and spends equal JAX's vmapped ladder exactly."""
    rng = np.random.default_rng(1)
    n = 512
    corr = rng.uniform(0.8, 1.0, n).astype(np.float32)
    stored = rng.uniform(0.0, 60.0, n).astype(np.float32)
    forecast = rng.uniform(0.0, 10.0, n).astype(np.float32)
    harv = rng.uniform(0.0, 20.0, n).astype(np.float32)
    scale = rng.choice([1.0, ten.BEARING_COST_SCALE, 0.7],
                       n).astype(np.float32)
    want = jax.vmap(lambda a, b, c, h, sc: jdec.choose_decision(
        a, b, c, jen.EnergyCosts(), harvested_uj=h if strict else None,
        cost_scale=sc))(*(jnp.asarray(x) for x in (corr, stored, forecast,
                                                   harv, scale)))
    t = torch.as_tensor
    got = tdec.choose_decision(t(corr), t(stored), t(forecast),
                               ten.EnergyCosts(),
                               harvested_uj=t(harv) if strict else None,
                               cost_scale=t(scale))
    np.testing.assert_array_equal(got.decision.numpy(),
                                  np.asarray(want.decision))
    np.testing.assert_array_equal(got.spend.numpy(), np.asarray(want.spend))
    assert len(set(got.decision.tolist())) >= 4


def test_cost_tables_match_jax():
    jc, tc = jen.EnergyCosts(), ten.EnergyCosts()
    assert tc.decision_costs() == jc.decision_costs()
    assert tc.stage_costs(12) == jc.stage_costs(12)
    assert [tc.total(i) for i in range(6)] == [jc.total(i) for i in range(6)]
    np.testing.assert_array_equal(tdec.decision_energy(tc).numpy(),
                                  np.asarray(jdec.decision_energy(jc)))
    assert (tdec.D0_MEMO, tdec.D4_SAMPLING, tdec.DEFER, tdec.D8_STAGED_FULL) \
        == (jdec.D0_MEMO, jdec.D4_SAMPLING, jdec.DEFER, jdec.D8_STAGED_FULL)


@pytest.mark.parametrize("fn", ["supercap_step", "supercap_step_direct"])
def test_supercap_matches_jax(fn):
    r = _rng(3)
    stored, harv, spent = (r.uniform(0, 220, 500).astype(np.float32)
                           for _ in range(3))
    ref = getattr(jen, fn)(stored, harv, spent)
    got = getattr(ten, fn)(_t(stored), _t(harv), _t(spent))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)


def test_predictor_matches_jax():
    n, w = 5, 8
    js, ts = jen.predictor_init(w, batch=n), ten.predictor_init(w, batch=n)
    js1, ts1 = jen.predictor_init(w), ten.predictor_init(w)
    for step in range(11):                      # wraps the ring buffer
        inc = _rng(10 + step).uniform(0, 50, n).astype(np.float32)
        js, ts = jen.predictor_update(js, inc), ten.predictor_update(ts, _t(inc))
        js1 = jen.predictor_update(js1, inc[0])
        ts1 = ten.predictor_update(ts1, _t(inc[0]))
        np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))
        np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
        np.testing.assert_allclose(ten.predictor_forecast(ts).numpy(),
                                   np.asarray(jen.predictor_forecast(js)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(ten.predictor_forecast(ts1)),
                                   float(jen.predictor_forecast(js1)),
                                   rtol=1e-6)


@pytest.mark.parametrize("source", ["rf", "wifi", "piezo", "solar"])
def test_harvest_traces_match_jax_in_distribution(source):
    n = 4000
    ref = np.asarray(jen.harvest_trace(jax.random.PRNGKey(0), n, source))
    got = ten.harvest_trace(torch.Generator().manual_seed(0), n, source)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert float(got.min()) >= 0.0
    np.testing.assert_allclose(float(got.mean()), ref.mean(), rtol=0.15)
    np.testing.assert_allclose(float((got == 0).float().mean()),
                               (ref == 0).mean(), atol=0.03)


def test_fleet_harvest_traces_layout():
    tr = ten.fleet_harvest_traces(torch.Generator().manual_seed(1), 8, 32)
    assert tr.shape == (8, 32) and bool((tr >= 0).all())
    np.testing.assert_array_equal(ten.fleet_source_assignment(8),
                                  jen.fleet_source_assignment(8))
    for i in range(7):
        assert not torch.allclose(tr[i], tr[i + 1])


# ---------------------------------------------------------------------------
# memo and AAC
# ---------------------------------------------------------------------------

def test_signature_correlations_match_jax(windows):
    sigs = _rng(4).standard_normal((12, T, C)).astype(np.float32)
    for w in windows:
        np.testing.assert_allclose(
            tmemo.signature_correlations(_t(w), _t(sigs)).numpy(),
            np.asarray(jmemo.signature_correlations(w, sigs)), rtol=1e-5,
            atol=1e-6)
    np.testing.assert_allclose(
        tmemo.pearson(_t(windows), _t(windows[::-1].copy()), axis=1).numpy(),
        np.asarray(jmemo.pearson(windows, windows[::-1], axis=1)), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("class_aware", [True, False])
def test_select_k_matches_jax(class_aware):
    r = _rng(5)
    # accuracy grows with k, by a class-dependent amount
    acc = np.sort(r.uniform(0.6, 0.9, (12, 5)), axis=1)
    table = jaac.make_aac_table(acc, [2, 4, 8, 12, 16])
    classes = r.integers(0, 12, 300).astype(np.int32)
    energy = r.uniform(0, 30, 300).astype(np.float32)
    ref = jax.vmap(lambda c, e: jaac.select_k(table, c, e,
                                              class_aware=class_aware))(
        classes, energy)
    got = tac.select_k(convert.aac_table(table), _t(classes), _t(energy),
                       class_aware=class_aware)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and len(set(got.tolist())) >= 2


# ---------------------------------------------------------------------------
# coresets
# ---------------------------------------------------------------------------

def test_points_from_window_matches_jax(windows):
    for w in windows:
        np.testing.assert_array_equal(
            tcs.points_from_window(_t(w)).numpy(),
            np.asarray(jcs.points_from_window(w)))
    np.testing.assert_array_equal(tcs.unit_grid(T).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, T)))


def test_window_from_points_matches_jax():
    r = _rng(6)
    for _ in range(4):
        pts = r.standard_normal((T, 2)).astype(np.float32)
        pts[5, 0] = pts[9, 0]                        # a tie in time
        np.testing.assert_allclose(
            tcs.window_from_points(_t(pts), T).numpy(),
            np.asarray(jcs.window_from_points(pts, T)), **FLOAT_TOL)
    batch = r.standard_normal((3, 4, T, 3)).astype(np.float32)
    want = np.stack([[np.asarray(jcs.window_from_points(p, T)) for p in b]
                     for b in batch])
    np.testing.assert_allclose(tcs.window_from_points(_t(batch), T).numpy(),
                               want, **FLOAT_TOL)


def test_channel_cluster_coresets_match_jax(windows):
    got = tcs.channel_cluster_coresets(_t(windows), k=12, iters=4)
    assert got.centers.shape == (5, C, 12, 2)
    for i, w in enumerate(windows):
        ref = jcs.channel_cluster_coresets(w, k=12, iters=4)
        np.testing.assert_allclose(got.centers[i].numpy(),
                                   np.asarray(ref.centers), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.radii[i].numpy(),
                                   np.asarray(ref.radii), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.counts[i].numpy(),
                                      np.asarray(ref.counts))
    one = tcs.channel_cluster_coresets(_t(windows[0]), k=12)
    np.testing.assert_array_equal(one.counts.numpy(), got.counts[0].numpy())


def test_importance_weights_match_jax(windows):
    got = tcs.importance_weights(_t(windows)).numpy()
    for i, w in enumerate(windows):
        np.testing.assert_allclose(got[i],
                                   np.asarray(jcs.importance_weights(w)),
                                   **FLOAT_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_median_averages_the_middle_pair_like_jnp():
    x = _rng(7).standard_normal((4, 10, 2)).astype(np.float32)   # even count
    got = tcs._median_flat(_t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(jnp.median)(x)))


def test_importance_coreset_matches_jax(windows):
    m = 20
    keys = jax.random.split(jax.random.PRNGKey(3), len(windows))
    u = np.stack([np.asarray(jax.random.uniform(k, (T,), minval=1e-9,
                                                maxval=1.0)) for k in keys])
    got = tcs.importance_coreset(_t(windows), m, _t(u))
    for i, (w, k) in enumerate(zip(windows, keys)):
        ref = jcs.importance_coreset(w, m, k)
        np.testing.assert_array_equal(got.indices[i].numpy(),
                                      np.asarray(ref.indices))
        np.testing.assert_array_equal(got.values[i].numpy(),
                                      np.asarray(ref.values))
        np.testing.assert_allclose(got.weights[i].numpy(),
                                   np.asarray(ref.weights), rtol=1e-5)
        np.testing.assert_allclose(got.mean[i].numpy(), np.asarray(ref.mean),
                                   **FLOAT_TOL)
        np.testing.assert_allclose(got.var[i].numpy(), np.asarray(ref.var),
                                   **FLOAT_TOL)


def test_payload_bytes_match_jax():
    assert tcs.raw_payload_bytes(60) == jcs.raw_payload_bytes(60) == 240
    assert tcs.cluster_payload_bytes(12) == jcs.cluster_payload_bytes(12)
    assert tcs.sampling_payload_bytes(20, channels=3) \
        == jcs.sampling_payload_bytes(20, channels=3)


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def _ball_draws(key, c, t):
    """The per-channel draws of recover_cluster_window (recovery.py:96) and
    _uniform_in_ball (recovery.py:56-59)."""
    dirs, radii = [], []
    for kk in jax.random.split(key, c):
        knorm, kdir = jax.random.split(kk)
        dirs.append(np.asarray(jax.random.normal(kdir, (t, 2))))
        radii.append(np.asarray(jax.random.uniform(knorm, (t, 1))))
    return np.stack(dirs), np.stack(radii)


def test_recover_cluster_window_matches_jax(windows):
    """Both recoveries start from JAX's coresets (the coresets' own parity is
    tested above), a batch of per-channel coresets at once."""
    keys = jax.random.split(jax.random.PRNGKey(4), len(windows))
    draws = [_ball_draws(k, C, T) for k in keys]
    dirs = np.stack([d for d, _ in draws])
    radii = np.stack([r for _, r in draws])
    cs_j = [jcs.channel_cluster_coresets(w, k=12) for w in windows]
    # AAC zeroes the clusters past the selected k: recover from such too
    cs_j = [cs._replace(counts=cs.counts.at[:, 9:].set(0)) if i % 2 else cs
            for i, cs in enumerate(cs_j)]
    cs_t = tcs.ClusterCoreset(*(_t(np.stack([np.asarray(getattr(cs, f))
                                             for cs in cs_j]))
                                for f in tcs.ClusterCoreset._fields))
    got = trec.recover_cluster_window(cs_t, _t(dirs), _t(radii), T)
    assert got.shape == (len(windows), T, C)
    for i, (cs, k) in enumerate(zip(cs_j, keys)):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(jrec.recover_cluster_window(cs, k, T)),
            **FLOAT_TOL)


def test_recover_cluster_points_joint_matches_jax():
    r = _rng(8)
    cs = jcs.ClusterCoreset(r.standard_normal((6, 3)).astype(np.float32),
                            r.uniform(0, 1, 6).astype(np.float32),
                            np.asarray([3, 0, 5, 1, 0, 4], np.int32))
    key = jax.random.PRNGKey(5)
    knorm, kdir = jax.random.split(key)
    dirs = np.asarray(jax.random.normal(kdir, (T, 3)))
    radii = np.asarray(jax.random.uniform(knorm, (T, 1)))
    ref_pts, ref_mask = jrec.recover_cluster_points(cs, key, T)
    got_pts, got_mask = trec.recover_cluster_points(
        tcs.ClusterCoreset(*(_t(x) for x in cs)), _t(dirs), _t(radii), T)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(ref_pts),
                               **FLOAT_TOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_recover_sampling_window_matches_jax(windows):
    gen = jrec.init_generator(jax.random.PRNGKey(6), T, C)
    keys = jax.random.split(jax.random.PRNGKey(7), len(windows))
    u = np.stack([np.asarray(jax.random.uniform(k, (T,), minval=1e-9,
                                                maxval=1.0)) for k in keys])
    sc_t = tcs.importance_coreset(_t(windows), 20, _t(u))
    latent = np.stack([np.asarray(jax.random.normal(k, (16,)))
                       for k in keys])
    got = trec.recover_sampling_window(convert.generator_params(gen), sc_t,
                                       _t(latent), T)
    for i, (w, k) in enumerate(zip(windows, keys)):
        sc = jcs.importance_coreset(w, 20, k)
        ref = jrec.recover_sampling_window(gen, sc, k, T)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_node_state_converts():
    from repro.serving.fleet import fleet_node_init
    st = convert.node_state(fleet_node_init(4, initial_uj=33.0))
    assert st.stored_uj.tolist() == [33.0] * 4
    assert st.predictor.history.shape == (4, 8)
    assert st.prev_label.dtype == torch.int32
