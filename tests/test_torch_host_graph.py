"""The host serve slot replayed as CUDA graphs, against its eager segments.

On a CUDA device :func:`repro_torch.host.host_serve_slot` captures the
slot's segments on the first call of a key and replays them after.  The
tests marked ``cuda`` hold the replays to the eager segments on the same
card (``python -m pytest -q --noconftest -m cuda
tests/test_torch_host_graph.py`` there, where JAX, which ``conftest.py``
imports, is absent; they skip without a card): every output field and
state leaf exactly, the ensemble's summed logits within 1e-6 (a CUDA
``index_add`` adds a node's rows in an unspecified order), the signatures
a ``noise_fn`` keeps, the results of earlier slots left as they were, and
one capture for each new key.  The CPU case runs the same segments eagerly and counts no capture.
Small sizes: 30 frames a slot from 32 nodes, 2 batches of 8 served, so
the backlog grows, the queue overflows and deadlines pass.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.recovery import init_generator  # noqa: E402
from repro_torch.host import (HostPayload, HostServeConfig,  # noqa: E402
                              cluster_entries, counter_noise,
                              host_serve_slot, host_serve_trace,
                              host_server_init, sampling_entries,
                              serve_graph_counts)
from repro_torch.host import server  # noqa: E402
from repro_torch.models.har import HARConfig, har_init  # noqa: E402
from repro_torch.serving.edge_host import (WirePayload,  # noqa: E402
                                           WireSamplePayload)

N, LANE, SLOTS, SEED = 32, 32, 7, 7
CFG = HostServeConfig(channels=3, k=12, m=20, t=60, n_classes=12, n_nodes=N,
                      batch_size=8, queue_capacity=40, cache_capacity=64,
                      qos_slots=1, batches_per_slot=2, telemetry=True)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lanes(dev, slots=SLOTS):
    """``slots`` lanes of LANE entries: cluster frames on even nodes,
    sampling frames on odd ones, a quarter of each slot's lane re-sent from
    the slot before (cache hits) and every sixteenth entry masked out."""
    g = torch.Generator().manual_seed(3)
    c, k, m, t = CFG.channels, CFG.k, CFG.m, CFG.t

    def ints(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=g).to(dtype)

    lanes, prev = [], None
    for _ in range(slots):
        lo = -torch.rand((LANE, 1, 1, 1), generator=g) - 1.0
        wire = WirePayload(
            ints((LANE, c, k, 2), -32768, 32768, torch.int16),
            ints((LANE, c, k), -128, 128, torch.int8),
            ints((LANE, c, k), 0, 16, torch.int8), lo, lo + 3.0,
            torch.rand((LANE, 1, 1), generator=g) + 0.1)
        idx = torch.stack([torch.randperm(t, generator=g)[:m]
                           for _ in range(LANE)]).sort(-1).values
        swire = WireSamplePayload(
            idx.to(torch.int8), ints((LANE, m, c), -32768, 32768,
                                     torch.int16),
            lo[:, 0], lo[:, 0] + 3.0, torch.randn((LANE, c), generator=g),
            torch.rand((LANE, c), generator=g))
        odd = (torch.arange(LANE) % 2).bool()
        ce, se = cluster_entries(wire, m), sampling_entries(swire, k)
        entries = HostPayload(*(torch.where(
            odd.reshape((-1,) + (1,) * (a.ndim - 1)), b, a)
            for a, b in zip(ce, se)))
        if prev is not None:
            entries = HostPayload(*(torch.cat([p[: LANE // 4], e[LANE // 4:]])
                                    for p, e in zip(prev, entries)))
        prev = entries
        lanes.append((HostPayload(*(x.to(dev) for x in entries)),
                      torch.arange(LANE, dtype=torch.int32, device=dev),
                      (torch.arange(LANE) % 16 != 15).to(dev)))
    return lanes


def _weights(dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = har_init(g, HARConfig())
    gen = init_generator(g, CFG.t, CFG.channels)
    return ({k: v.to(dev) for k, v in params.items()},
            type(gen)(*(x.to(dev) for x in gen)))


def _keeping_noise():
    """A ``noise_fn`` that keeps the signatures it is handed, as the
    benchmark's does, and draws :func:`counter_noise`."""
    kept = []

    def fn(sigs):
        kept.append(sigs)
        return counter_noise(sigs, seed=SEED, channels=CFG.channels, t=CFG.t)
    return fn, kept


def _eager_slot(state, lane, cfg, params, gen, noise_fn):
    """One slot through the eager segments on the state's device."""
    entries, nid, mask = lane
    consts = server._slot_consts(cfg, "slot", entries.kind.shape[0],
                                 state.slot.device)
    segs = server._segments(cfg, consts, params, gen)
    return server._run_eager(segs, (state, entries, nid, mask), noise_fn)[0]


def _chain(slot_fn, state, lanes):
    states, outs = [], []
    for lane in lanes:
        state, out = slot_fn(state, lane)
        states.append(state)
        outs.append(out)
    return states, outs


def _leaves(tree):
    out = []
    server.tree_map(lambda a: out.append(a) or a, tree)
    return out


def _assert_same_state(got, want):
    for a, b in zip(_leaves(got._replace(ensemble_logits=None)),
                    _leaves(want._replace(ensemble_logits=None))):
        assert torch.equal(a, b)
    torch.testing.assert_close(got.ensemble_logits, want.ensemble_logits,
                               rtol=0, atol=1e-6)


def _assert_same_out(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_replay_matches_eager_segments(cuda_dev):
    """Seven chained slots with telemetry and a ``noise_fn`` that keeps its
    signatures: the first call captures, the next six replay 3 graphs each;
    outputs, states and kept signatures equal the eager segments', and
    none of what an earlier slot handed out moved under a later replay."""
    lanes = _lanes(cuda_dev)
    params, gen = _weights(cuda_dev)
    fn_e, kept_e = _keeping_noise()
    want = _chain(lambda s, ln: _eager_slot(s, ln, CFG, params, gen, fn_e),
                  host_server_init(CFG, cuda_dev), lanes)
    fn_g, kept_g = _keeping_noise()
    before = serve_graph_counts()
    got = _chain(lambda s, ln: host_serve_slot(
        s, *ln, cfg=CFG, host_params=params, gen_params=gen, noise_fn=fn_g),
        host_server_init(CFG, cuda_dev), lanes)
    torch.cuda.synchronize()
    after = serve_graph_counts()
    segs = CFG.batches_per_slot + 1
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == (SLOTS - 1) * segs
    assert after["eager_segments"] - before["eager_segments"] == segs
    assert len(kept_g) == len(kept_e) == SLOTS * CFG.batches_per_slot
    for a, b in zip(kept_g, kept_e):
        assert torch.equal(a, b)
    for sg, se in zip(got[0], want[0]):
        _assert_same_state(sg, se)
    for og, oe in zip(got[1], want[1]):
        _assert_same_out(og, oe)
    # the slots served rows, hit the cache and missed deadlines
    last = got[0][-1]
    assert int(last.served) > 0 and int(last.cache.hits) > 0
    assert int(last.deadline_misses) > 0 and int(last.queue.drops_overflow) > 0


@pytest.mark.cuda
def test_default_noise_is_one_graph_a_slot(cuda_dev):
    """With ``noise_fn=None`` the slot is one graph: each replay equals the
    eager segment and the segmented slot given the same noise as a
    ``noise_fn``; ``host_serve_trace`` equals the chained slots."""
    lanes = _lanes(cuda_dev, 4)
    params, gen = _weights(cuda_dev)
    before = serve_graph_counts()
    got = _chain(lambda s, ln: host_serve_slot(
        s, *ln, cfg=CFG, host_params=params, gen_params=gen, seed=SEED),
        host_server_init(CFG, cuda_dev), lanes)
    after = serve_graph_counts()
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 3
    fn = functools.partial(counter_noise, seed=SEED, channels=CFG.channels,
                           t=CFG.t)
    want = _chain(lambda s, ln: _eager_slot(s, ln, CFG, params, gen, fn),
                  host_server_init(CFG, cuda_dev), lanes)
    split = _chain(lambda s, ln: host_serve_slot(
        s, *ln, cfg=CFG, host_params=params, gen_params=gen, noise_fn=fn),
        host_server_init(CFG, cuda_dev), lanes)
    for other in (want, split):
        for sg, se in zip(got[0], other[0]):
            _assert_same_state(sg, se)
        for og, oe in zip(got[1], other[1]):
            _assert_same_out(og, oe)
    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    entries = HostPayload(*(stack(*xs) for xs in zip(*(ln[0] for ln in lanes))))
    state, out = host_serve_trace(
        host_server_init(CFG, cuda_dev), entries,
        stack(*(ln[1] for ln in lanes)), stack(*(ln[2] for ln in lanes)),
        cfg=CFG, host_params=params, gen_params=gen, seed=SEED)
    _assert_same_state(state, got[0][-1])
    for si, o in enumerate(got[1]):
        _assert_same_out([x[si] for x in out], o)


@pytest.mark.cuda
def test_new_weights_or_config_capture_once(cuda_dev):
    """New weight tensors and a new configuration each capture once; an
    in-place update of the captured weights is read by the replay."""
    lanes = _lanes(cuda_dev, 3)
    params, gen = _weights(cuda_dev)
    fn, _ = _keeping_noise()

    def run(cfg, p):
        state = host_server_init(cfg, cuda_dev)
        for lane in lanes:
            state, out = host_serve_slot(state, *lane, cfg=cfg,
                                         host_params=p, gen_params=gen,
                                         noise_fn=fn)
        return state, out

    def captures():
        return serve_graph_counts()["captures"]

    run(CFG, params)
    n0 = captures()
    run(CFG, params)
    assert captures() == n0
    fresh = {k: v.clone() for k, v in params.items()}
    run(CFG, fresh)
    assert captures() == n0 + 1
    run(CFG, fresh)
    assert captures() == n0 + 1
    wider = dataclasses.replace(CFG, qos_slots=3)
    run(wider, params)
    assert captures() == n0 + 2
    fresh["head_b"].add_(0.5)
    state, out = run(CFG, fresh)
    assert captures() == n0 + 2
    want = host_server_init(CFG, cuda_dev)
    for lane in lanes:
        want, want_out = _eager_slot(want, lane, CFG, fresh, gen, fn)
    _assert_same_state(state, want)
    _assert_same_out(out, want_out)


def test_cpu_runs_segments_eagerly():
    """On the CPU nothing is captured: the slot runs its 3 segments
    eagerly, with a ``noise_fn`` or without, and a chain of slots given the
    default noise as a ``noise_fn`` equals one ``host_serve_trace``."""
    lanes = _lanes(torch.device("cpu"), 4)
    params, gen = _weights("cpu")
    fn = functools.partial(counter_noise, seed=SEED, channels=CFG.channels,
                           t=CFG.t)
    before = serve_graph_counts()
    states, outs = _chain(lambda s, ln: host_serve_slot(
        s, *ln, cfg=CFG, host_params=params, gen_params=gen, noise_fn=fn),
        host_server_init(CFG, "cpu"), lanes)
    mid = serve_graph_counts()
    entries = HostPayload(*(torch.stack(xs)
                            for xs in zip(*(ln[0] for ln in lanes))))
    state, out = host_serve_trace(
        host_server_init(CFG, "cpu"), entries,
        torch.stack([ln[1] for ln in lanes]),
        torch.stack([ln[2] for ln in lanes]), cfg=CFG, host_params=params,
        gen_params=gen, seed=SEED)
    after = serve_graph_counts()
    assert after["captures"] == before["captures"]
    assert after["replays"] == before["replays"]
    assert mid["eager_segments"] - before["eager_segments"] == 4 * 3
    assert after["eager_segments"] - mid["eager_segments"] == 4 * 3
    for a, b in zip(_leaves(state), _leaves(states[-1])):
        assert torch.equal(a, b)
    for si, o in enumerate(outs):
        _assert_same_out([x[si] for x in out], o)
    assert int(state.served) > 0 and int(state.cache.hits) > 0
    assert int(state.deadline_misses) > 0
    assert int(state.queue.drops_overflow) > 0
