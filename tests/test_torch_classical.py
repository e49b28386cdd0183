"""``repro_torch.core.classical`` (the DCT, Haar DWT and Fourier top-m
codecs of Table 1 and Fig. 10) against ``repro.core.classical`` on the same
numpy windows, on the CPU, at the HAR (60, 3) and bearing (120, 1) shapes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.core import classical as jcl  # noqa: E402

from repro_torch.core import classical as tcl  # noqa: E402

# float32 transforms summed in another order (matmul, pocketfft)
RECON_TOL = dict(rtol=1e-5, atol=1e-5)
CODECS = ["dct_compress", "dwt_compress", "fourier_compress"]
SHAPES = [(60, 3), (120, 1)]


def _windows(t, c, n=4, seed=0):
    r = np.random.default_rng(seed + t)
    trend = np.sin(np.linspace(0, 5, t))[None, :, None]
    return (r.standard_normal((n, t, c)) + trend).astype(np.float32)


@pytest.mark.parametrize("m", [6, 14, 20])
@pytest.mark.parametrize("t,c", SHAPES)
@pytest.mark.parametrize("codec", CODECS)
def test_codec_matches_jax(codec, t, c, m):
    for win in _windows(t, c):
        want = np.asarray(getattr(jcl, codec)(win, m))
        got = getattr(tcl, codec)(torch.from_numpy(win), m)
        assert got.shape == (t, c) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **RECON_TOL)


@pytest.mark.parametrize("t,c", SHAPES)
@pytest.mark.parametrize("codec", CODECS)
def test_batched_codec_is_the_window_loop(codec, t, c):
    wins = torch.from_numpy(_windows(t, c, n=5, seed=1))
    fn = getattr(tcl, codec)
    got = fn(wins.reshape(5, 1, t, c), 14)
    assert got.shape == (5, 1, t, c)
    for i in range(5):
        torch.testing.assert_close(got[i, 0], fn(wins[i], 14), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("t,c", SHAPES)
def test_dct_basis_matches_jax(t, c):
    np.testing.assert_allclose(tcl._dct_basis(t).numpy(),
                               np.asarray(jcl._dct_basis(t)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("t", [60, 120, 7, 64, 1024])
def test_haar_levels_match_jax(t):
    assert tcl._haar_levels(t) == jcl._haar_levels(t)


def test_haar_levels_of_the_paper_windows():
    assert (tcl._haar_levels(60), tcl._haar_levels(120)) == (2, 3)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_ties_keep_more_coefficients(m):
    coeffs = np.asarray([[3.0, 1.0], [-1.0, 2.0], [3.0, 2.0], [2.0, 0.5],
                         [-3.0, 2.0]], np.float32)
    want = np.asarray(jcl._topm_reconstruct(coeffs, m))
    got = tcl._topm_reconstruct(torch.from_numpy(coeffs), m).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] != 0).sum() == 3 and (got[:, 1] != 0).sum() >= 3


@pytest.mark.parametrize("m", [6, 14, 20])
@pytest.mark.parametrize("t,c", SHAPES)
def test_kept_coefficient_counts(t, c, m):
    """Without ties, the DCT keeps exactly m coefficients a channel."""
    win = torch.from_numpy(_windows(t, c, n=1)[0])
    coeffs = tcl._dct_basis(t) @ win
    kept = tcl._topm_reconstruct(coeffs, m)
    assert ((kept != 0).sum(dim=0) == m).all()


@pytest.mark.parametrize("m", [6, 14, 20])
def test_payload_bytes_equal_jax(m):
    assert tcl.classical_payload_bytes(m) == jcl.classical_payload_bytes(m)
    assert (tcl.classical_payload_bytes(m, 2, 4)
            == jcl.classical_payload_bytes(m, 2, 4))
