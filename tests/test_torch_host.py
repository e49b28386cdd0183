"""The port's host serving tier against ``repro.host`` on the CPU: the same
numpy inputs through both packages.

The port never reproduces ``jax.random``; where the reference keys a
payload's recovery by ``fold_in(fold_in(base_key, sig[0]), sig[1])``, the
port's server takes a ``noise_fn`` of the signatures, and these tests pass
one returning exactly JAX's draws for those words (the split discipline of
``repro/core/recovery.py:94-112`` and ``:167``).  Integer state (queue,
cursor, served, misses, drops, cache, votes, telemetry) must be exactly
equal; logits within ``LOGIT_TOL`` (the port's convolutions sum in another
order than XLA's).  Sizes are small: N <= 12 nodes, queue capacity 8-12,
batch 4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

from repro import host as jhost  # noqa: E402
from repro.configs.seeker_har import HAR  # noqa: E402
from repro.core.coreset import (channel_cluster_coresets,  # noqa: E402
                                importance_coreset)
from repro.core.recovery import init_generator  # noqa: E402
from repro.host import cache as jcache  # noqa: E402
from repro.host import queue as jq  # noqa: E402
from repro.host import scheduler as jsched  # noqa: E402
from repro.models.har import har_init  # noqa: E402
from repro.serving import (encode_wire_coresets,  # noqa: E402
                           encode_wire_samples, stack_task_params)
from repro.serving import fleet_serve_step as jax_fleet_serve_step  # noqa: E402
from repro.sharding import make_mesh_compat  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import host as thost  # noqa: E402
from repro_torch.configs.seeker_har import HAR as THAR  # noqa: E402
from repro_torch.host import cache as tcache  # noqa: E402
from repro_torch.host import queue as tq  # noqa: E402
from repro_torch.host import scheduler as tsched  # noqa: E402
from repro_torch.obs import CompileBudgetError, compile_guard  # noqa: E402
from repro_torch.serving import fleet_serve_step  # noqa: E402
from repro_torch.serving import stack_task_params as tstack  # noqa: E402

from test_torch_wire import har_like_windows  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
S, LANE = 6, 8


def jax_noise_fn(base_key, c, t):
    """A port ``noise_fn`` returning the draws the reference server makes
    for each row's signature words."""
    @jax.jit
    def draws(sigs):
        def one(s):
            key = jax.random.fold_in(jax.random.fold_in(base_key, s[0]), s[1])

            def per_channel(kk):
                knorm, kdir = jax.random.split(kk)
                return (jax.random.normal(kdir, (t, 2), jnp.float32),
                        jax.random.uniform(knorm, (t, 1), jnp.float32))

            dirs, radii = jax.vmap(per_channel)(jax.random.split(key, c))
            return dirs, radii, jax.random.normal(key, (16,), jnp.float32)
        return jax.vmap(one)(sigs)

    def fn(sigs):
        d, r, lat = draws(jnp.asarray(sigs.cpu().numpy().astype(np.uint32)))
        return {k: torch.from_numpy(np.array(v)).to(sigs.device)
                for k, v in (("dirs", d), ("radii_u", r), ("latent", lat))}
    return fn


def jax_split_noise(key, n, c, t):
    """The direct mode's draws: ``split(key, n)`` per node, then the
    per-channel split of ``recover_cluster_window``."""
    def one(kk):
        def per_channel(k2):
            knorm, kdir = jax.random.split(k2)
            return (jax.random.normal(kdir, (t, 2), jnp.float32),
                    jax.random.uniform(knorm, (t, 1), jnp.float32))
        return jax.vmap(per_channel)(jax.random.split(kk, c))
    d, r = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    return {"dirs": torch.from_numpy(np.array(d)),
            "radii_u": torch.from_numpy(np.array(r))}


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    params = har_init(key, HAR)
    params_b = har_init(jax.random.fold_in(key, 5), HAR)
    gen = init_generator(key, HAR.window, HAR.channels)
    wins = jnp.asarray(har_like_windows(0, 8))
    centers, radii, counts = jax.vmap(
        lambda w: channel_cluster_coresets(w, k=12, iters=4))(wins)
    wire = encode_wire_coresets(centers, radii, counts)
    sc = jax.vmap(lambda w, k: importance_coreset(w, 20, k))(
        wins, jax.random.split(jax.random.PRNGKey(6), 8))
    swire = encode_wire_samples(sc.indices, sc.values, sc.mean, sc.var)
    return dict(
        key=key, params=params, params_b=params_b, gen=gen, wins=wins,
        wire=wire, swire=swire,
        t_params=convert.har_params(params),
        t_params_b=convert.har_params(params_b),
        t_gen=convert.generator_params(gen),
        noise_fn=jax_noise_fn(key, HAR.channels, HAR.window))


def _cfg(mod, **kw):
    base = dict(channels=HAR.channels, k=12, m=20, t=HAR.window,
                n_classes=HAR.n_classes, n_nodes=8, batch_size=4,
                queue_capacity=16, cache_capacity=16, qos_slots=4)
    base.update(kw)
    return mod.HostServeConfig(**base)


def _pool(d):
    """16 JAX entries: the 8 cluster payloads (tasks 0, 1, 0, ...) then the
    8 sampling payloads (tasks 1, 0, 1, ...)."""
    tasks = jnp.arange(8) % 2
    ce = jhost.cluster_entries(d["wire"], 20, tasks=tasks)
    se = jhost.sampling_entries(d["swire"], 12, tasks=1 - tasks)
    return jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                  ce, se)


def _assert_tree_equal(got, want, what, float_tol=None):
    """Every leaf of the port's tree equal to JAX's (floats within
    ``float_tol`` where given, else exactly)."""
    if want is None:
        assert got is None, what
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{what}.{k}", float_tol)
        return
    if isinstance(want, tuple):
        for f, g, w in zip(want._fields, got, want):
            _assert_tree_equal(g, w, f"{what}.{f}", float_tol)
        return
    w = np.asarray(want)
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    if w.dtype == np.uint32:
        w = w.astype(np.int64)
    if float_tol is not None and np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, err_msg=what, **float_tol)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


# ---------------------------------------------------------------------------
# payload_signature: the same two uint32 words
# ---------------------------------------------------------------------------

def test_payload_signature_word_identical(setup):
    pool = _pool(setup)
    # -0.0 against 0.0, a NaN with a payload, and two's-complement wraps
    pool = pool._replace(
        c_lo=pool.c_lo.at[0].set(-0.0).at[1].set(0.0),
        s_mean=pool.s_mean.at[9, 1].set(jnp.float32(np.nan)),
        r_codes=pool.r_codes.at[2, 0, 0].set(-128),
        c_codes=pool.c_codes.at[3, 1, 2, 0].set(-32768),
        task=pool.task.at[4].set(-1))
    want = np.asarray(jax.vmap(jcache.payload_signature)(pool))
    t_pool = convert.host_payload(pool)
    got = tcache.batch_signatures(t_pool)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    one = tcache.payload_signature(type(t_pool)(*(x[9] for x in t_pool)))
    np.testing.assert_array_equal(one.numpy(), want[9].astype(np.int64))
    # -0.0 and 0.0 differ only in c_lo's sign bit: distinct signatures
    zero = pool._replace(c_lo=pool.c_lo.at[0].set(0.0))
    assert not np.array_equal(
        np.asarray(jax.vmap(jcache.payload_signature)(zero))[0], want[0])


# ---------------------------------------------------------------------------
# The queue: bulk path, sequential overflow walk, the slot's lane push
# ---------------------------------------------------------------------------

def _mini(mod, cap, deadlines=(), arrival=0):
    """A queue with a () int32 payload id, holding ``deadlines``."""
    if mod is jq:
        q = jq.queue_init({"pid": jnp.zeros((), jnp.int32)}, cap)
        n = len(deadlines)
        q, _ = jq.queue_push_batch(
            q, {"pid": jnp.arange(100, 100 + n, dtype=jnp.int32)},
            jnp.arange(n, dtype=jnp.int32), jnp.full((n,), arrival, jnp.int32),
            jnp.asarray(deadlines, jnp.int32), jnp.ones((n,), bool))
        return q
    q = tq.queue_init({"pid": torch.zeros((), dtype=torch.int32)}, cap)
    n = len(deadlines)
    q, _ = tq.queue_push_batch(
        q, {"pid": torch.arange(100, 100 + n, dtype=torch.int32)},
        torch.arange(n, dtype=torch.int32),
        torch.full((n,), arrival, dtype=torch.int32),
        torch.tensor(deadlines, dtype=torch.int32),
        torch.ones((n,), dtype=torch.bool))
    return q


def _lane(mod, deadlines, mask, arrival=1):
    n = len(deadlines)
    if mod is jq:
        return ({"pid": jnp.arange(n, dtype=jnp.int32)},
                jnp.arange(50, 50 + n, dtype=jnp.int32),
                jnp.full((n,), arrival, jnp.int32),
                jnp.asarray(deadlines, jnp.int32), jnp.asarray(mask))
    return ({"pid": torch.arange(n, dtype=torch.int32)},
            torch.arange(50, 50 + n, dtype=torch.int32),
            torch.full((n,), arrival, dtype=torch.int32),
            torch.tensor(deadlines, dtype=torch.int32), torch.tensor(mask))


# (resident deadlines, lane deadlines, lane mask), capacity 8
_PUSH_CASES = {
    "bulk": ([5, 3], [4, 9, 1, 7], [True, True, False, True]),
    "overflow evicts and drops": ([9, 3, 9, 5, 7, 2],
                                  [4, 10, 1, 9, 6, 3],
                                  [True, True, False, True, True, True]),
    "full, every push dropped": ([1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 8],
                                 [True, True, True]),
    "wrapped cursor": ([6, 6, 6, 6, 6, 6, 6], [2, 7, 3, 6],
                       [True, False, True, True]),
}


@pytest.mark.parametrize("case", sorted(_PUSH_CASES))
def test_queue_push_batch_equals_jax(case):
    resident, dls, mask = _PUSH_CASES[case]
    want_q, want_n = jq.queue_push_batch(_mini(jq, 8, resident),
                                         *_lane(jq, dls, mask))
    got_q, got_n = tq.queue_push_batch(_mini(tq, 8, resident),
                                       *_lane(tq, dls, mask))
    _assert_tree_equal(got_q, want_q, case)
    assert int(got_n) == int(want_n)


# one deadline for the whole lane, as a serve slot pushes: free slots,
# then evictions of later deadlines, then drops
_LANE_CASES = {
    "fill only": ([5, 3, 4], 6, [True, False, True, True]),
    "fill, evict, drop": ([9, 3, 9, 5, 7, 2], 6,
                          [True, True, False, True, True, True, True]),
    "full, evict ties by slot": ([8, 8, 2, 8, 1, 8, 3, 8], 4,
                                 [True] * 6),
    "full, nothing later": ([1, 2, 3, 4, 5, 6, 7, 8], 8, [True] * 5),
    "empty lane": ([9, 3], 6, [False] * 4),
}


@pytest.mark.parametrize("case", sorted(_LANE_CASES))
def test_push_lane_equals_jax_sequential_walk(case):
    resident, d, mask = _LANE_CASES[case]
    dls = [d] * len(mask)
    want_q, want_n = jq.queue_push_batch(_mini(jq, 8, resident),
                                         *_lane(jq, dls, mask))
    pl, nid, arr, _, m = _lane(tq, dls, mask)
    got_q, got_n = tq.push_lane(_mini(tq, 8, resident), pl, nid, 1, d, m)
    _assert_tree_equal(got_q, want_q, case)
    assert int(got_n) == int(want_n)
    # and the general walk agrees
    walk_q, _ = tq.queue_push_batch(_mini(tq, 8, resident),
                                    *_lane(tq, dls, mask))
    _assert_tree_equal(walk_q, want_q, case)


def test_single_push_and_edf_order_with_ties_equal_jax():
    resident = [7, 3, 7, 3, 9, 1, 3]
    for mod in (jq, tq):
        q = _mini(mod, 8, resident)
        one = ({"pid": jnp.asarray(7, jnp.int32)} if mod is jq
               else {"pid": torch.tensor(7, dtype=torch.int32)})
        q, dropped = mod.queue_push(q, one, 40, 1, 2)     # the last free slot
        q, dropped2 = mod.queue_push(q, one, 41, 1, 0)    # evicts a 9
        sched = jsched if mod is jq else tsched
        pops = []
        for _ in range(3):
            q, batch, missed = sched.edf_pop_batch(q, 3, now=2)
            pops.append((np.asarray(batch.node_id), np.asarray(batch.valid),
                         np.asarray(batch.deadline), int(missed)))
        if mod is jq:
            want, want_q = pops, q
        else:
            got, got_q = pops, q
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    _assert_tree_equal(got_q, want_q, "queue")


def test_cache_fifo_wrap_and_lookup_equal_jax():
    rng = np.random.default_rng(4)
    sigs = rng.integers(0, 2 ** 32, (6, 2), dtype=np.uint64).astype(np.uint32)
    sigs[3] = sigs[1]                                   # a duplicate
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    first = np.array([True, True, False, True, False, False])
    second = np.array([True, False, True, True, True, True])
    jc = jcache.cache_init(4, 5)
    tc = tcache.cache_init(4, 5)
    for ins in (first, second):
        jc = jcache.cache_insert_batch(jc, jnp.asarray(sigs),
                                       jnp.asarray(logits), jnp.asarray(ins))
        tc = tcache.cache_insert_batch(
            tc, torch.from_numpy(sigs.astype(np.int64)),
            torch.from_numpy(logits), torch.from_numpy(ins))
        _assert_tree_equal(tc, jc, "cache")
    valid = np.array([True, True, True, False, True, True])
    jh, jl = jcache.cache_lookup_batch(jc, jnp.asarray(sigs),
                                       jnp.asarray(valid))
    th, tl = tcache.cache_lookup_batch(
        tc, torch.from_numpy(sigs.astype(np.int64)), torch.from_numpy(valid))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy()[th.numpy()],
                                  np.asarray(jl)[np.asarray(jh)])


# ---------------------------------------------------------------------------
# The serve loop against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_inputs(setup):
    """S slots of an 8-wide lane drawn from 16 payloads (mixed kinds, two
    tasks, repeats across slots), arriving faster than the 4 rows a slot
    serves: backlog, overflow drops, deadline misses and cache hits."""
    pool = _pool(setup)
    rng = np.random.default_rng(11)
    pick = np.stack([rng.permutation(16)[:LANE] for _ in range(S)])
    entries = jax.tree_util.tree_map(lambda a: a[pick], pool)
    node_ids = rng.integers(0, 12, (S, LANE)).astype(np.int32)
    masks = rng.random((S, LANE)) < 0.85
    return entries, node_ids, masks


def _trace_cfg(mod):
    return _cfg(mod, n_nodes=12, queue_capacity=12, cache_capacity=8,
                qos_slots=1, telemetry=True, n_tasks=2)


@pytest.fixture(scope="module")
def traces(setup, trace_inputs):
    entries, node_ids, masks = trace_inputs
    jcfg, tcfg = _trace_cfg(jhost), _trace_cfg(thost)
    want = jhost.host_serve_trace(
        jhost.host_server_init(jcfg), entries, jnp.asarray(node_ids),
        jnp.asarray(masks), cfg=jcfg,
        host_params=stack_task_params((setup["params"], setup["params_b"])),
        gen_params=setup["gen"], base_key=setup["key"])
    kw = dict(cfg=tcfg, host_params=tstack((setup["t_params"],
                                            setup["t_params_b"])),
              gen_params=setup["t_gen"], noise_fn=setup["noise_fn"])
    got = thost.host_serve_trace(
        thost.host_server_init(tcfg, "cpu"), convert.host_payload(entries),
        torch.from_numpy(node_ids), torch.from_numpy(masks), **kw)
    return want, got, kw


def test_host_serve_trace_equals_jax(traces):
    (want_state, want_out), (got_state, got_out), _ = traces
    _assert_tree_equal(got_state, want_state, "state", LOGIT_TOL)
    _assert_tree_equal(got_out, want_out, "slot outputs", LOGIT_TOL)
    stats = thost.host_server_stats(got_state)
    # the trace exercised every QoS path and both payload kinds
    assert stats["drops_overflow"] > 0 and stats["deadline_misses"] > 0
    assert stats["cache_hits"] > 0 and stats["backlog"] > 0
    served_kinds = got_state.metrics
    assert int(served_kinds["host.sojourn_slots.cluster"].sum()) > 0
    assert int(served_kinds["host.sojourn_slots.sampling"].sum()) > 0


def test_stats_and_ensemble_equal_jax(traces):
    (want_state, _), (got_state, _), kw = traces
    jcfg = _trace_cfg(jhost)
    want = jhost.host_server_stats(want_state, jcfg)
    got = thost.host_server_stats(got_state, kw["cfg"])
    assert got.keys() == want.keys()
    assert got == want
    je, te = jhost.host_ensemble(want_state), thost.host_ensemble(got_state)
    for k in ("counts", "pred_vote", "pred_mean"):
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]), k)
    np.testing.assert_allclose(te["mean_logits"].numpy(),
                               np.asarray(je["mean_logits"]), **LOGIT_TOL)


def test_chained_slots_are_one_trace_bitwise(setup, trace_inputs, traces):
    entries, node_ids, masks = trace_inputs
    _, (trace_state, trace_out), kw = traces
    t_entries = convert.host_payload(entries)
    state = thost.host_server_init(kw["cfg"], "cpu")
    outs = []
    for si in range(S):
        state, out = thost.host_serve_slot(
            state, type(t_entries)(*(x[si] for x in t_entries)),
            torch.from_numpy(node_ids[si]), torch.from_numpy(masks[si]), **kw)
        outs.append(out)
    for a, b in zip(convert.to_numpy(state), convert.to_numpy(trace_state)):
        _assert_tree_equal(a, b, "state")
    for f, a, b in zip(thost.SlotOutput._fields, zip(*outs), trace_out):
        assert torch.equal(torch.stack(a), b), f


def test_default_noise_makes_a_hit_a_recomputation(setup):
    """With the port's own counter noise: the same payloads again are all
    cache hits, bitwise the first answers, and a fresh server recomputes
    them bitwise; the noise is a function of the signature words."""
    cfg = _cfg(thost, batch_size=8)
    entries = thost.cluster_entries(convert.wire_payload(setup["wire"]),
                                    cfg.m)
    nid = torch.arange(8, dtype=torch.int32)
    mask = torch.ones(8, dtype=torch.bool)
    kw = dict(cfg=cfg, host_params=setup["t_params"],
              gen_params=setup["t_gen"], seed=3)
    state, first = thost.host_serve_slot(thost.host_server_init(cfg, "cpu"),
                                         entries, nid, mask, **kw)
    state, again = thost.host_serve_slot(state, entries, nid, mask, **kw)
    assert bool(again.cache_hit.all())
    assert torch.equal(first.logits, again.logits)
    _, fresh = thost.host_serve_slot(thost.host_server_init(cfg, "cpu"),
                                     entries, nid, mask, **kw)
    assert torch.equal(first.logits, fresh.logits)
    sigs = tcache.batch_signatures(entries)
    a = thost.counter_noise(sigs, seed=3, channels=3, t=60)
    b = thost.counter_noise(sigs.flip(0), seed=3, channels=3, t=60)
    c = thost.counter_noise(sigs, seed=4, channels=3, t=60)
    assert torch.equal(a["dirs"], b["dirs"].flip(0))
    assert not torch.equal(a["dirs"], c["dirs"])
    assert tuple(a["dirs"].shape) == (8, 3, 60, 2)
    assert tuple(a["radii_u"].shape) == (8, 3, 60, 1)
    assert tuple(a["latent"].shape) == (8, 16)
    assert 0.0 <= float(a["radii_u"].min()) and float(a["radii_u"].max()) < 1
    assert abs(float(a["dirs"].mean())) < 0.1
    assert abs(float(a["dirs"].std()) - 1.0) < 0.1


def test_compile_budget_counts_shapes_built(setup):
    cfg = _cfg(thost, batch_size=3, queue_capacity=24, qos_slots=2,
               cache_capacity=11)
    entries = thost.cluster_entries(convert.wire_payload(setup["wire"]),
                                    cfg.m)
    nid = torch.arange(8, dtype=torch.int32)
    kw = dict(cfg=cfg, host_params=setup["t_params"],
              gen_params=setup["t_gen"])
    rng = np.random.RandomState(7)
    state = thost.host_server_init(cfg, "cpu")
    before = thost.serve_trace_count(cfg)
    with compile_guard("host.serve", 2):
        for _ in range(4):
            active = torch.from_numpy(rng.rand(8) < rng.uniform(0.1, 0.9))
            state, _ = thost.host_serve_slot(state, entries, nid, active,
                                             **kw)
    assert thost.serve_trace_count(cfg) - before == 1
    with pytest.raises(CompileBudgetError):
        with compile_guard("host.serve", 0):
            thost.host_serve_slot(
                thost.host_server_init(
                    dataclasses.replace(cfg, qos_slots=3), "cpu"),
                entries, nid, torch.ones(8, dtype=torch.bool),
                **dict(kw, cfg=dataclasses.replace(cfg, qos_slots=3)))


def test_batch_task_counts_equal_jax(setup):
    pool = _pool(setup)
    for mod, sched, p in ((jq, jsched, pool),
                          (tq, tsched, convert.host_payload(pool))):
        q = mod.queue_init(jax.tree_util.tree_map(lambda a: a[0], pool)
                           if mod is jq else type(p)(*(x[0] for x in p)), 8)
        sub = (jax.tree_util.tree_map(lambda a: a[:5], p) if mod is jq
               else type(p)(*(x[:5] for x in p)))
        lane = _lane(mod, [4] * 5, [True, True, False, True, True])
        q, _ = mod.queue_push_batch(q, sub, *lane[1:])
        q, batch, _ = sched.edf_pop_batch(q, 6)
        counts = np.asarray(sched.batch_task_counts(batch, 2))
        if mod is jq:
            want = counts
    np.testing.assert_array_equal(counts, want)
    assert counts.sum() == 4


# ---------------------------------------------------------------------------
# fleet_serve_step, both single-device modes, against the reference on a
# 1-device mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return make_mesh_compat((1,), ("data",))


def test_fleet_serve_step_direct_mode_equals_jax(setup, mesh):
    wins = setup["wins"][:6]
    want = jax_fleet_serve_step(wins, host_params=setup["params"],
                                har_cfg=HAR, mesh=mesh, key=setup["key"])
    got = fleet_serve_step(
        torch.from_numpy(np.array(wins)), host_params=setup["t_params"],
        har_cfg=THAR, noise=jax_split_noise(setup["key"], 6, 3, 60),
        device="cpu")
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["raw_bytes"] == want["raw_bytes"]
    np.testing.assert_allclose(got["host_logits"].numpy(),
                               np.asarray(want["host_logits"]), **LOGIT_TOL)


def test_fleet_serve_step_queue_mode_equals_jax(setup, mesh):
    """Two rounds through the host server with a caller churn mask and an
    engine alive lane (composed by AND): the dead nodes send nothing, the
    second round is served from the cache."""
    wins = setup["wins"][:6]
    caller = np.array([True, False, True, True, True, True])
    engine = np.array([True, True, True, False, True, True])
    jcfg = _cfg(jhost, n_nodes=6, queue_capacity=8)
    tcfg = _cfg(thost, n_nodes=6, queue_capacity=8)
    jstate = jhost.host_server_init(jcfg)
    tstate = thost.host_server_init(tcfg, "cpu")
    t_wins = torch.from_numpy(np.array(wins))
    want = jax_fleet_serve_step(
        wins, host_params=setup["params"], har_cfg=HAR, mesh=mesh,
        key=setup["key"], host_state=jstate, serve_cfg=jcfg,
        gen_params=setup["gen"], alive=jnp.asarray(caller),
        engine_alive=jnp.asarray(engine))
    kw = dict(host_params=setup["t_params"], har_cfg=THAR, serve_cfg=tcfg,
              gen_params=setup["t_gen"], noise_fn=setup["noise_fn"],
              alive=torch.from_numpy(caller),
              engine_alive=torch.from_numpy(engine), device="cpu")
    got = fleet_serve_step(t_wins, host_state=tstate, **kw)
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["raw_bytes"] == want["raw_bytes"]
    _assert_tree_equal(got["host_state"], want["host_state"], "state",
                       LOGIT_TOL)
    _assert_tree_equal(got["slot_output"], want["slot_output"], "out",
                       LOGIT_TOL)
    out = got["slot_output"]
    assert sorted(out.node_id[out.valid].tolist()) == [0, 2, 4, 5]
    # the second round is answered from the cache, bitwise the first
    again = fleet_serve_step(t_wins, host_state=got["host_state"], **kw)
    stats = thost.host_server_stats(again["host_state"])
    assert stats["cache_hits"] == 4 and stats["served"] == 8
    first = dict(zip(out.node_id[out.valid].tolist(), out.logits[out.valid]))
    out2 = again["slot_output"]
    for n, row in zip(out2.node_id[out2.valid].tolist(),
                      out2.logits[out2.valid]):
        assert torch.equal(row, first[n])


# ---------------------------------------------------------------------------
# Error paths: the reference's messages, word for word
# ---------------------------------------------------------------------------

def _raises(fn, exc=ValueError):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


_CONFIG_CASES = {
    **{f"{f} < 1": {f: 0} for f in ("channels", "k", "m", "t", "n_classes",
                                    "n_nodes", "batch_size",
                                    "queue_capacity", "cache_capacity",
                                    "n_tasks")},
    "qos_slots < 0": {"qos_slots": -1},
    "batches_per_slot < 0": {"batches_per_slot": -1},
    "batch over capacity": {"batch_size": 17},
}


@pytest.mark.parametrize("case", [
    "mesh", "per_shard_host", "queue mode without serve_cfg",
    "alive without a queue", "engine_alive without a queue",
    "alive shape", "engine_alive shape", "lane wider than capacity",
    "fleet round wider than capacity", *sorted(_CONFIG_CASES)])
def test_error_paths(setup, mesh, case):
    wins = setup["wins"][:4]
    t_wins = torch.from_numpy(np.array(wins))
    jkw = dict(host_params=setup["params"], har_cfg=HAR, mesh=mesh,
               key=setup["key"])
    tkw = dict(host_params=setup["t_params"], har_cfg=THAR, device="cpu")
    if case in ("mesh", "per_shard_host"):
        # the port's mesh is a torch DeviceMesh; a JAX mesh is refused
        extra = ({} if case == "mesh" else dict(
            per_shard_host=True,
            host_state=thost.host_server_init_stacked(_cfg(thost), 1, "cpu"),
            serve_cfg=_cfg(thost), gen_params=setup["t_gen"]))
        msg = _raises(lambda: fleet_serve_step(t_wins, mesh=mesh, **extra,
                                               **tkw))
        assert msg == ("mesh must be a torch.distributed.device_mesh."
                       "DeviceMesh, got Mesh")
        return
    if case in _CONFIG_CASES:
        want = _raises(lambda: _cfg(jhost, **_CONFIG_CASES[case]))
        assert _raises(lambda: _cfg(thost, **_CONFIG_CASES[case])) == want
        return
    if case == "queue mode without serve_cfg":
        want = _raises(lambda: jax_fleet_serve_step(
            wins, host_state=jhost.host_server_init(_cfg(jhost)), **jkw))
        got = _raises(lambda: fleet_serve_step(
            t_wins, host_state=thost.host_server_init(_cfg(thost), "cpu"),
            **tkw))
    elif case in ("alive without a queue", "engine_alive without a queue",
                  "alive shape", "engine_alive shape"):
        arg = "engine_alive" if case.startswith("engine") else "alive"
        n = 3 if case.endswith("shape") else 4
        qj = (dict(host_state=jhost.host_server_init(_cfg(jhost)))
              if case.endswith("shape") else {})
        qt = (dict(host_state=thost.host_server_init(_cfg(thost), "cpu"))
              if case.endswith("shape") else {})
        want = _raises(lambda: jax_fleet_serve_step(
            wins, **{arg: jnp.ones((n,), bool)}, **qj, **jkw))
        got = _raises(lambda: fleet_serve_step(
            t_wins, **{arg: torch.ones(n, dtype=torch.bool)}, **qt, **tkw))
    elif case == "lane wider than capacity":
        jcfg, tcfg = _cfg(jhost, queue_capacity=8), _cfg(thost,
                                                         queue_capacity=8)
        pool = _pool(setup)
        lane = jax.tree_util.tree_map(lambda a: a[:9], pool)
        want = _raises(lambda: jhost.host_serve_slot(
            jhost.host_server_init(jcfg), lane, jnp.arange(9),
            jnp.ones((9,), bool), cfg=jcfg, host_params=setup["params"],
            gen_params=setup["gen"], base_key=setup["key"]))
        got = _raises(lambda: thost.host_serve_slot(
            thost.host_server_init(tcfg, "cpu"), convert.host_payload(lane),
            torch.arange(9), torch.ones(9, dtype=torch.bool), cfg=tcfg,
            host_params=setup["t_params"], gen_params=setup["t_gen"]))
    else:                                   # fleet round wider than capacity
        jcfg, tcfg = _cfg(jhost, queue_capacity=4), _cfg(thost,
                                                         queue_capacity=4)
        want = _raises(lambda: jhost.serve_fleet_payloads(
            jhost.host_server_init(jcfg), setup["wire"], jnp.arange(8),
            cfg=jcfg, host_params=setup["params"], gen_params=setup["gen"],
            base_key=setup["key"]))
        got = _raises(lambda: thost.serve_fleet_payloads(
            thost.host_server_init(tcfg, "cpu"),
            convert.wire_payload(setup["wire"]), torch.arange(8), cfg=tcfg,
            host_params=setup["t_params"], gen_params=setup["t_gen"]))
    assert got == want
