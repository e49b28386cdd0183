"""The port's per-node keyed noise, ``repro_torch.fleet_node_keys`` and the
engines' ``node_keys=``/``final_keys``, on the CPU.

The twin of the reference's ``fleet_node_keys`` (node ``i``'s stream is
``fold_in(key, i)``) with other numbers: node ``i``'s key is hashed from
(seed, i), its slot draws from a counter hash of its key, and its key
advances in every slot it runs.  Held here: the keys' prefix property; a
node's draws independent of the fleet it is drawn in; a keyed run equal
to the same engine fed the same draws through ``noise=``; the streamed
driver chained through ``final_keys`` equal to one long run; the draws'
moments; and the three noise sources excluding each other.  The sharded
keyed runs are held to the single-device one on 8 gloo ranks in
``tests/test_torch_sharded.py``.

The scarce-harvest fleet of ``tests/_torch_sharded_worker.py`` (13 nodes,
6 slots, churn, brown-out, the intermittent lane, telemetry) is built
from a seed with the port alone.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core.counter_hash import (counter_words,  # noqa: E402
                                           word_uniforms)
from repro_torch.serving import fleet as tfleet  # noqa: E402

import _torch_sharded_worker as worker  # noqa: E402

T, C = 60, 3
TRACES = ("decisions", "payload_bytes", "stored_uj", "k_trace", "logits",
          "alive", "brownout", "it_emit", "it_label", "it_src", "it_stage")


@pytest.fixture(scope="module")
def fleet():
    """The lanes' fleet, keyed, run once on one thread (the bitwise checks
    compare runs of one thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = worker.keyed_inputs()
        w, h = kw.pop("windows"), kw.pop("harvest")
        res = repro_torch.seeker_fleet_simulate(w, h, **kw)
        yield dict(w=w, h=h, kw=kw, res=res)
    finally:
        torch.set_num_threads(threads)


def test_node_keys_prefix_and_spread():
    big = repro_torch.fleet_node_keys(7, 4096, "cpu")
    assert big.shape == (4096, 2) and big.dtype == torch.int64
    assert torch.equal(repro_torch.fleet_node_keys(7, 13, "cpu"), big[:13])
    assert int(big.min()) >= 0 and int(big.max()) < 2 ** 32
    assert len(set(map(tuple, big.tolist()))) == 4096
    for other in (8, 7 + 2 ** 32, -7):
        assert not torch.equal(repro_torch.fleet_node_keys(other, 13, "cpu"),
                               big[:13]), other


@pytest.mark.parametrize("n", [1, 13, 300])
def test_node_draws_do_not_depend_on_the_fleet(n):
    """Node ``i``'s draws in a fleet of N are those of a fleet of one given
    key ``i``: every entry and the advanced key, bit for bit."""
    keys = repro_torch.fleet_node_keys(3, n, "cpu")
    noise, nxt = tfleet.draw_slot_noise_keyed(keys, T, C)
    for i in sorted({0, n // 2, n - 1}):
        one, one_next = tfleet.draw_slot_noise_keyed(keys[i:i + 1], T, C)
        for k in tfleet.NOISE_KEYS:
            assert torch.equal(noise[k][i:i + 1], one[k]), (i, k)
        assert torch.equal(nxt[i:i + 1], one_next), i
    want = {"u": (n, T), "dirs": (n, C, T, 2), "radii_u": (n, C, T, 1),
            "latent": (n, tfleet.LATENT)}
    assert {k: tuple(v.shape) for k, v in noise.items()} == want
    assert not torch.equal(nxt, keys)


def test_keyed_draw_moments():
    """2**16 draws of each kind: uniforms in (0, 1] with mean 0.5 within
    0.01; normals with mean 0 within 0.01 and variance 1 within 0.02; the
    slot's uniforms in their draw_slot_noise ranges."""
    keys = repro_torch.fleet_node_keys(11, 2048, "cpu")
    noise, _ = tfleet.draw_slot_noise_keyed(keys, 32, 1)
    m = 2 ** 16
    raw = word_uniforms(counter_words(keys[:, 0], 32)).reshape(-1)[:m]
    assert 0.0 < float(raw.min()) and float(raw.max()) <= 1.0
    assert abs(float(raw.double().mean()) - 0.5) < 0.01
    for k in ("u", "radii_u"):
        u = noise[k].reshape(-1)[:m].double()
        assert u.numel() == m
        assert float(u.min()) >= (1e-9 if k == "u" else 0.0), k
        assert float(u.max()) < 1.0, k
        assert abs(float(u.mean()) - 0.5) < 0.01, k
    z = noise["dirs"].reshape(-1)[:m].double()
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0) < 0.02
    lat = noise["latent"].reshape(-1).double()
    assert abs(float(lat.mean())) < 0.02 and abs(float(lat.var()) - 1) < 0.03


def test_keyed_run_equals_its_draws_fed_through_noise(fleet):
    """The keyed run's traces equal the engine fed the same draws through
    ``noise=``: each slot drawn from the keys, which advance where the
    emitted ``alive`` lane says the node ran (frozen through dead and
    browned-out slots), ending at ``final_keys``."""
    res = fleet["res"]
    alive = res["alive"]
    assert int((~alive).sum()) > 0 and int(res["brownout_slots"]) > 0
    keys, slots = fleet["kw"]["node_keys"], []
    for si in range(alive.shape[0]):
        nz, nxt = tfleet.draw_slot_noise_keyed(keys, T, C)
        slots.append(nz)
        keys = torch.where(alive[si][:, None], nxt, keys)
    noise = {k: torch.stack([sl[k] for sl in slots])
             for k in tfleet.NOISE_KEYS}
    kw = dict(fleet["kw"])
    kw.pop("node_keys")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fed = repro_torch.seeker_fleet_simulate(fleet["w"], fleet["h"],
                                                noise=noise, **kw)
    finally:
        torch.set_num_threads(threads)
    for k in TRACES:
        assert torch.equal(res[k], fed[k]), k
    assert torch.equal(res["final_keys"], keys)
    assert "final_keys" not in fed


def test_streamed_chain_through_final_keys_is_one_run(fleet):
    """Segments of 4 and 2 slots, chained through ``final_keys ->
    node_keys``, are bitwise one 6-slot run, ``final_keys`` included; so is
    a hand-made chain of two engine calls."""
    res, kw = fleet["res"], fleet["kw"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        streamed = repro_torch.seeker_fleet_simulate_streamed(
            fleet["w"], fleet["h"], chunk=worker.CHUNK, **kw)
        first = repro_torch.seeker_fleet_simulate(
            fleet["w"][:, :3], fleet["h"][:, :3],
            **dict(kw, labels=kw["labels"][:3], alive=kw["alive"][:, :3]))
        second = repro_torch.seeker_fleet_simulate(
            fleet["w"][:, 3:], fleet["h"][:, 3:],
            **dict(kw, labels=kw["labels"][3:], alive=kw["alive"][:, 3:],
                   node_keys=first["final_keys"],
                   state0=first["final_state"],
                   brownout_state0=first["final_brownout"],
                   intermittent_state0=first["final_intermittent"],
                   slot0=3))
    finally:
        torch.set_num_threads(threads)
    assert streamed["n_chunks"] == 2
    for k in TRACES:
        assert torch.equal(streamed[k], res[k]), k
        assert torch.equal(torch.cat([first[k], second[k]]), res[k]), k
    assert torch.equal(streamed["final_keys"], res["final_keys"])
    assert torch.equal(second["final_keys"], res["final_keys"])


@pytest.mark.parametrize("engine", ["single", "streamed", "sharded"])
@pytest.mark.parametrize("pair", [("generator", "noise"),
                                  ("generator", "node_keys"),
                                  ("noise", "node_keys")])
def test_noise_sources_exclude_each_other(fleet, engine, pair):
    n, s = fleet["h"].shape
    given = {"generator": torch.Generator().manual_seed(0),
             "noise": tfleet.draw_fleet_noise(
                 torch.Generator().manual_seed(0), s, n, T, C),
             "node_keys": repro_torch.fleet_node_keys(0, n, "cpu")}
    kw = dict(fleet["kw"], node_keys=None)
    kw.update({k: given[k] for k in pair})
    fn = {"single": repro_torch.seeker_fleet_simulate,
          "streamed": lambda *a, **k: repro_torch.
          seeker_fleet_simulate_streamed(*a, chunk=2, **k),
          "sharded": repro_torch.seeker_fleet_simulate_sharded}[engine]
    with pytest.raises(ValueError, match="one of generator="):
        fn(fleet["w"], fleet["h"], **kw)


def test_default_generator_is_seed_zero(fleet):
    """Without a source the run draws from ``manual_seed(0)``, as before
    the keyed source existed."""
    kw = dict(fleet["kw"], node_keys=None)
    a = repro_torch.seeker_fleet_simulate(fleet["w"], fleet["h"], **kw)
    b = repro_torch.seeker_fleet_simulate(
        fleet["w"], fleet["h"], generator=torch.Generator().manual_seed(0),
        **kw)
    for k in TRACES:
        assert torch.equal(a[k], b[k]), k
    assert "final_keys" not in a
