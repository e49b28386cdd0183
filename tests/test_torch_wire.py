"""The port's edge-to-host wire format against ``repro``'s, on the CPU: the
cases of tests/test_wire_format.py, with the same numpy inputs through
both packages.  Codes and frames must be identical (byte for byte), every
``ValueError`` message word for word, and dequantized floats within the
stated tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro.core import aac as jaac  # noqa: E402
from repro.core import coreset as jcs  # noqa: E402
from repro.serving import edge_host as jeh  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import aac as taac  # noqa: E402
from repro_torch.core import coreset as tcs  # noqa: E402
from repro_torch.serving import edge_host as teh  # noqa: E402

K = 12


def har_like_windows(seed, n, t=60, c=3):
    """(n, T, C) float32 windows made with numpy: per-channel sinusoids of
    random frequency and phase plus noise, HAR-like in scale."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t)[None, :, None] / t
    freq = rng.uniform(1.0, 6.0, (n, 1, c))
    phase = rng.uniform(0.0, 2 * np.pi, (n, 1, c))
    amp = rng.uniform(0.5, 2.0, (n, 1, c))
    noise = 0.2 * rng.standard_normal((n, t, c))
    return (amp * np.sin(2 * np.pi * freq * tt + phase) + noise).astype(
        np.float32)
# dequantized floats: the same float32 ops in the same order
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def coresets():
    wins = jnp.asarray(har_like_windows(3, 4))
    centers, radii, counts = jax.vmap(
        lambda w: jcs.channel_cluster_coresets(w, k=K, iters=4))(wins)
    return tuple(np.array(x) for x in (centers, radii, counts))


@pytest.fixture(scope="module")
def payloads(coresets):
    """The JAX payload and the port's, encoded from the same numpy."""
    jp = jeh.encode_wire_coresets(*(jnp.asarray(x) for x in coresets))
    tp = teh.encode_wire_coresets(*(torch.from_numpy(x) for x in coresets))
    return jp, tp


@pytest.fixture(scope="module")
def samples():
    wins = jnp.asarray(har_like_windows(5, 4))
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    sc = jax.vmap(lambda w, k: jcs.importance_coreset(w, 20, k))(wins, keys)
    fields = tuple(np.array(x) for x in (sc.indices, sc.values, sc.mean,
                                           sc.var))
    jp = jeh.encode_wire_samples(*(jnp.asarray(x) for x in fields))
    tp = teh.encode_wire_samples(*(torch.from_numpy(x) for x in fields))
    return fields, jp, tp


def _message(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_codes_equal_jax_and_in_range(payloads):
    jp, tp = payloads
    for f in jeh.WirePayload._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    assert int(tp.n_codes.min()) >= 0 and int(tp.n_codes.max()) <= 15


def test_frames_are_byte_identical(payloads):
    jp, tp = payloads
    frame = teh.wire_payload_to_bytes(tp)
    assert frame == jeh.wire_payload_to_bytes(jp)
    q = teh.wire_payload_from_bytes(frame)
    for a, b in zip(tp, q):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the port parses JAX's frame, and JAX the port's, into equal tensors
    jq = jeh.wire_payload_from_bytes(frame)
    for a, b in zip(jq, q):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_decode_matches_jax_and_roundtrip_bounds(coresets, payloads):
    centers, radii, counts = coresets
    jp, tp = payloads
    got = teh.decode_wire_coresets(tp)
    want = jeh.decode_wire_coresets(jp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FLOAT_TOL)
    assert got[2].dtype == torch.int32
    c_step = (tp.hi - tp.lo).numpy() / 65535.0
    assert (np.abs(got[0].numpy() - centers) <= c_step * 0.5 + 1e-5).all()
    r_step = tp.rhi.numpy() / 255.0
    assert (np.abs(got[1].numpy() - radii) <= r_step * 0.5 + 1e-5).all()
    small = counts <= 15
    np.testing.assert_array_equal(got[2].numpy()[small], counts[small])


def test_counts_clip_at_4bit():
    p = teh.encode_wire_coresets(torch.zeros((1, 1, 3, 2)),
                                 torch.ones((1, 1, 3)),
                                 torch.tensor([[[2, 15, 60]]]))
    np.testing.assert_array_equal(p.n_codes[0, 0].numpy(), [2, 15, 15])


def test_byte_accounting(payloads):
    _, tp = payloads
    b, c, k, _ = tp.c_codes.shape
    actual = sum(x.numel() * x.element_size()
                 for x in (tp.c_codes, tp.r_codes, tp.n_codes))
    assert actual == b * teh.wire_payload_nbytes(k, c)
    assert teh.wire_payload_nbytes(k, c) == jeh.wire_payload_nbytes(k, c)
    assert teh.wire_sample_nbytes(20, 3) == jeh.wire_sample_nbytes(20, 3) \
        == 20 * (1 + 2 * 3) + 4 * 3
    assert tcs.cluster_payload_bytes(12) == 42


def _bad_coresets(p, mod):
    """The malformed cluster payloads of tests/test_wire_format.py, built
    with the package ``mod``'s tensors."""
    if mod is jeh:
        def cast(x, dt):
            return x.astype(dt)
        f32, i16, i32 = jnp.float32, jnp.int16, jnp.int32
        at16 = p.n_codes.at[0, 0, 0].set(16)
    else:
        def cast(x, dt):
            return x.to(dt)
        f32, i16, i32 = torch.float32, torch.int16, torch.int32
        at16 = p.n_codes.clone()
        at16[0, 0, 0] = 16
    return {
        "c_codes float": p._replace(c_codes=cast(p.c_codes, f32)),
        "r_codes int16": p._replace(r_codes=cast(p.r_codes, i16)),
        "n_codes int32": p._replace(n_codes=cast(p.n_codes, i32)),
        "r_codes shape": p._replace(r_codes=p.r_codes[:, :, :-1]),
        "n_codes shape": p._replace(n_codes=p.n_codes[:-1]),
        "c_codes not 2-D": p._replace(c_codes=p.c_codes[..., :1]),
        "lo int": p._replace(lo=cast(p.lo, i32)),
        "count 16": p._replace(n_codes=at16),
    }


@pytest.mark.parametrize("case", ["c_codes float", "r_codes int16",
                                  "n_codes int32", "r_codes shape",
                                  "n_codes shape", "c_codes not 2-D",
                                  "lo int", "count 16"])
def test_decode_errors_match_jax(payloads, case):
    jp, tp = payloads
    want = _message(jeh.decode_wire_coresets, _bad_coresets(jp, jeh)[case])
    assert _message(teh.decode_wire_coresets,
                    _bad_coresets(tp, teh)[case]) == want


def _frames(frame, b, c, k):
    n_off = 20 + 4 * b * c * k + b * c * k
    bad_count = bytearray(frame)
    bad_count[n_off] = 200
    nan_lo = bytearray(frame)
    nan_lo[20 + 6 * b * c * k:20 + 6 * b * c * k + 4] = \
        np.float32(np.nan).tobytes()
    hi_lo = bytearray(frame)                       # hi < lo in window 0
    off = 20 + 6 * b * c * k
    hi_lo[off:off + 4] = np.float32(1e6).tobytes()
    version = bytearray(frame)
    version[4:8] = np.uint32(2).tobytes()
    zero_k = bytearray(frame)
    zero_k[16:20] = np.uint32(0).tobytes()
    return {"truncated": frame[:-3], "short": frame[:10],
            "magic": b"\x00" * len(frame), "count": bytes(bad_count),
            "nan range": bytes(nan_lo), "hi < lo": bytes(hi_lo),
            "version": bytes(version), "degenerate": bytes(zero_k)}


@pytest.mark.parametrize("case", ["truncated", "short", "magic", "count",
                                  "nan range", "hi < lo", "version",
                                  "degenerate"])
def test_frame_errors_match_jax(payloads, case):
    jp, tp = payloads
    b, c, k, _ = tp.c_codes.shape
    buf = _frames(teh.wire_payload_to_bytes(tp), b, c, k)[case]
    assert _message(teh.wire_payload_from_bytes, buf) == _message(
        jeh.wire_payload_from_bytes, buf)


def test_sample_codes_and_decode_match_jax(samples):
    (idx, values, mean, var), jp, tp = samples
    for f in jeh.WireSamplePayload._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    got = teh.decode_wire_samples(tp)
    want = jeh.decode_wire_samples(jp)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), idx)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FLOAT_TOL)
    step = (tp.hi - tp.lo).numpy() / 65535.0
    assert (np.abs(got[1].numpy() - values) <= step * 0.5 + 1e-5).all()


def _bad_samples(p, mod):
    if mod is jeh:
        idx32, v8 = p.idx.astype(jnp.int32), p.v_codes.astype(jnp.int8)
        neg = p.idx.at[0, 0].set(-3)
    else:
        idx32, v8 = p.idx.to(torch.int32), p.v_codes.to(torch.int8)
        neg = p.idx.clone()
        neg[0, 0] = -3
    return {"idx int32": p._replace(idx=idx32),
            "v_codes int8": p._replace(v_codes=v8),
            "idx shape": p._replace(idx=p.idx[:, :-1]),
            "moments": p._replace(mean=p.mean[:, :-1]),
            "negative": p._replace(idx=neg)}


@pytest.mark.parametrize("case", ["idx int32", "v_codes int8", "idx shape",
                                  "moments", "negative", "encode index 200"])
def test_sample_errors_match_jax(samples, case):
    (idx, values, mean, var), jp, tp = samples
    if case == "encode index 200":
        bad = idx.copy()
        bad[0, 0] = 200
        want = _message(jeh.encode_wire_samples, jnp.asarray(bad),
                        jnp.asarray(values), jnp.asarray(mean),
                        jnp.asarray(var))
        got = _message(teh.encode_wire_samples, torch.from_numpy(bad),
                       torch.from_numpy(values), torch.from_numpy(mean),
                       torch.from_numpy(var))
    else:
        want = _message(jeh.decode_wire_samples, _bad_samples(jp, jeh)[case])
        got = _message(teh.decode_wire_samples, _bad_samples(tp, teh)[case])
    assert got == want


def test_convert_round_trips_payloads(payloads, samples):
    jp, tp = payloads
    for a, b in zip(convert.wire_payload(jp), tp):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, jsp, tsp = samples
    for a, b in zip(convert.wire_sample_payload(jsp), tsp):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_uniform_matches_jax(bits):
    x = np.random.default_rng(7).standard_normal((5, 12, 2)).astype(
        np.float32) * 3
    lo, hi = np.float32(-2.5), np.float32(4.0)
    got = tcs.quantize_uniform(torch.from_numpy(x), bits, torch.tensor(lo),
                               torch.tensor(hi))
    want = jcs.quantize_uniform(jnp.asarray(x), bits, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tcs.dequantize_uniform(got, bits, torch.tensor(lo),
                               torch.tensor(hi)).numpy(),
        np.asarray(jcs.dequantize_uniform(want, bits, lo, hi)), **FLOAT_TOL)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_encode_cluster_coreset_matches_jax(d):
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((K, d)).astype(np.float32)
    radii = rng.uniform(0.0, 0.5, K).astype(np.float32)
    counts = rng.integers(0, 12, K).astype(np.int32)
    enc_t = tcs.encode_cluster_coreset(tcs.ClusterCoreset(
        torch.from_numpy(centers), torch.from_numpy(radii),
        torch.from_numpy(counts)))
    enc_j = jcs.encode_cluster_coreset(jcs.ClusterCoreset(
        jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(counts)))
    for a, b in zip(enc_t, enc_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dec_t = tcs.decode_cluster_coreset(enc_t)
    dec_j = jcs.decode_cluster_coreset(enc_j)
    for a, b in zip(dec_t, dec_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FLOAT_TOL)


def test_aac_payload_bytes_matches_jax():
    ks = [4, 6, 8, 12, 5]
    got = taac.aac_payload_bytes(torch.tensor(ks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jaac.aac_payload_bytes(ks)))


def test_edge_encode_matches_jax():
    """The edge half: the port's coresets of the same windows, quantized,
    give the reference's codes (the CPU runs the plain k-means)."""
    wins = jnp.asarray(har_like_windows(3, 4))
    jp = jeh._edge_encode_coresets(wins, K)
    tp = teh._edge_encode_coresets(torch.from_numpy(np.array(wins)), K)
    np.testing.assert_array_equal(tp.n_codes.numpy(), np.asarray(jp.n_codes))
    for f in ("c_codes", "r_codes"):
        diff = np.abs(getattr(tp, f).numpy().astype(np.int32)
                      - np.asarray(getattr(jp, f)).astype(np.int32))
        assert diff.max() <= 1, f
    for f in ("lo", "hi", "rhi"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-5,
                                   atol=1e-6)
