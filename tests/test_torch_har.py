"""``repro_torch.models.har`` against ``repro.models.har`` with the same
weights (``har_init`` converted through ``repro_torch.convert``), and the
port's torch-driven sensor data against the JAX generators' structure.

The quantized paths are compared with JAX as it runs compiled (``jax.jit``,
as the fleet engine runs it); see tests/test_torch_kernels.py for why."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.configs.seeker_har import HAR  # noqa: E402
from repro.core.memo import signature_correlations  # noqa: E402
from repro.data.sensors import class_signatures, har_window  # noqa: E402
from repro.models import har as jhar  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.seeker_har import HAR as THAR  # noqa: E402
from repro_torch.core import memo as tmemo  # noqa: E402
from repro_torch.data import sensors as tsens  # noqa: E402
from repro_torch.models import har as thar  # noqa: E402

FP_TOL = dict(rtol=1e-5, atol=1e-5)
Q_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    params = jhar.har_init(jax.random.PRNGKey(0), HAR)
    # the workload's windows (the signal family both packages generate)
    x = tsens.har_stream(torch.Generator().manual_seed(0), 8)[0].numpy()
    return params, convert.har_params(params), x


def test_config_matches_jax():
    assert THAR == thar.HARConfig(**vars(HAR))


def test_har_init_shapes_match_jax(model):
    params, _, _ = model
    tp = thar.har_init(torch.Generator().manual_seed(0), THAR)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in params.items()}


def test_har_apply_matches_jax(model):
    params, tp, x = model
    got = thar.har_apply(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jhar.har_apply(params, x)),
                               **FP_TOL)


@pytest.mark.parametrize("bits", [16, 12])
def test_quantize_params_matches_jax(model, bits):
    params, tp, _ = model
    want = jax.jit(jhar.quantize_params, static_argnums=1)(params, bits)
    got = thar.quantize_params(tp, bits)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("bits", [16, 12])
def test_har_apply_quantized_matches_jax(model, bits):
    params, tp, x = model
    want = np.asarray(jax.jit(jhar.har_apply_quantized, static_argnums=2)(
        params, x, bits))
    got = thar.har_apply_quantized(tp, torch.from_numpy(x), bits).numpy()
    np.testing.assert_allclose(got, want, **Q_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("bits", [16, 12])
def test_har_apply_quantized_nodes_is_the_jax_fleet_vmap(model, bits):
    """Per-node activation scales: the JAX fleet's vmap of
    ``har_apply_quantized(params, window[None])`` over nodes."""
    params, tp, x = model
    want = np.asarray(jax.jit(jax.vmap(
        lambda w: jhar.har_apply_quantized(params, w[None], bits)[0]))(x))
    got = thar.har_apply_quantized_nodes(
        thar.quantize_params(tp, bits), torch.from_numpy(x), bits).numpy()
    np.testing.assert_allclose(got, want, **Q_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# Sensor data: the same signal family, drawn from a torch.Generator
# ---------------------------------------------------------------------------

def test_har_stream_shapes_and_dwell():
    g = torch.Generator().manual_seed(0)
    w, lab = tsens.har_stream(g, 20)
    assert w.shape == (20, 60, 3) and lab.shape == (20,)
    assert (lab[:8] == lab[0]).all() and (lab[8:16] == lab[8]).all()
    wn, ln = tsens.har_stream(g, 10, streams=4)
    assert wn.shape == (4, 10, 60, 3) and ln.shape == (4, 10)
    assert not torch.allclose(wn[0], wn[1])
    assert tsens.har_window(g, 3).shape == (60, 3)


def test_bearing_streams_match_jax_in_distribution():
    """Drawn from a ``torch.Generator``, the bearing windows match JAX's in
    distribution: per class, the mean of the windows' standard deviation
    and of their peak within 3% (3000 windows, about 300 a class)."""
    from repro.data.sensors import bearing_dataset
    w, lab = bearing_dataset(jax.random.PRNGKey(0), 3000)
    w, lab = np.asarray(w), np.asarray(lab)
    pw, plab = tsens.bearing_dataset(torch.Generator().manual_seed(0),
                                        3000)
    pw, plab = pw.numpy(), plab.numpy()
    assert pw.shape == w.shape and set(plab.tolist()) == set(range(10))
    for c in range(10):
        for stat in (lambda x: x.std(axis=1), lambda x: np.abs(x).max(axis=1)):
            want, got = stat(w[lab == c]).mean(), stat(pw[plab == c]).mean()
            assert abs(got - want) <= 0.03 * want, c
    gen = torch.Generator().manual_seed(1)
    sw, sl = tsens.bearing_stream(gen, 40, t=HAR.window, streams=3)
    assert sw.shape == (3, 40, HAR.window, 1) and sl.shape == (3, 40)
    assert bool((sl[:, :16] == sl[:, :1]).all())          # dwell 16
    hw, hl = tsens.har_dataset(gen, 5)
    assert hw.shape == (5, 60, 3) and hl.shape == (5,)
    assert tsens.bearing_window(gen, 3).shape == (120, 1)


def test_signatures_memoize_like_jax():
    """The memoization premise holds for the port's data as for JAX's: a
    window correlates with its own class's signature about as often, and
    about as strongly."""
    labels = np.tile(np.arange(12), 10)
    keys = jax.random.split(jax.random.PRNGKey(1), len(labels))
    jw = jax.vmap(har_window)(keys, labels)
    jsig = class_signatures()
    jc = np.asarray(jax.vmap(lambda w: signature_correlations(w, jsig))(jw))
    sigs = tsens.class_signatures()
    assert sigs.shape == (12, 60, 3)
    tw = tsens.har_windows(torch.Generator().manual_seed(1),
                           torch.from_numpy(labels))
    tc = torch.stack([tmemo.signature_correlations(w, sigs)
                      for w in tw]).numpy()
    acc_j = (jc.argmax(-1) == labels).mean()
    acc_t = (tc.argmax(-1) == labels).mean()
    assert acc_t > 4 / 12 and abs(acc_t - acc_j) < 0.15
    assert abs(tc.max(-1).mean() - jc.max(-1).mean()) < 0.02
