"""The port's observability layer against the JAX package, on the CPU:
``repro_torch.obs.registry`` against ``repro.obs.registry`` on the same numpy
inputs, exactly (int32 pairs at the digit boundaries, round half to even,
log and categorical histograms, merges, percentiles); the span tracer's
Chrome-trace export; and the port's lane registry ``FLEET_LANES``, which
must mirror the JAX one field by field, apart from the JAX PRNG-key lane
and the ``init`` module paths.
"""
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import registry as jreg  # noqa: E402
from repro.serving import fleet as jfleet  # noqa: E402
from repro.serving import fleet_lanes as jlanes  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.obs import registry as treg  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402
from repro_torch.serving import fleet_lanes as tlanes  # noqa: E402

# values at the base-2**16 digit boundaries and the top of int32
EDGE_INTS = np.array([0, 1, 2**16 - 1, 2**16, 2**16 + 1, 2**31 - 1, 12345,
                      2**20 + 7], np.int32)
# float payloads on the rounding boundary: half to even in both packages
HALVES = np.array([0.5, 1.5, 2.5, 3.49, 65535.5, 65536.5, 7.0, 1e6 + 0.5],
                  np.float32)


def _spec(pkg):
    return pkg.MetricsSpec((
        pkg.counter("c.bytes", "B"), pkg.counter("c.n"), pkg.gauge("g.level"),
        pkg.histogram("h.lat", 8, lo=0.5, hi=300.0, unit="ms"),
        pkg.histogram("h.code", 6, log=False)))


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].dtype == torch.int32, k


@pytest.mark.parametrize("values,mask", [
    (EDGE_INTS, None),
    (EDGE_INTS, EDGE_INTS % 3 != 0),
    (HALVES, None),
    (HALVES, np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)),
    (np.array([True, False, True, True]), None),
])
def test_int_pair_sum_matches_jax(values, mask):
    got = treg.int_pair_sum(torch.as_tensor(values),
                            None if mask is None else torch.as_tensor(mask))
    want = jreg.int_pair_sum(jnp.asarray(values),
                             None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert treg.int_pair_total(got) == jreg.int_pair_total(want)


def test_counters_gauges_histograms_fold_like_jax():
    """A run of updates on both registries, slot by slot: counters (single
    and stacked), a gauge, a log and a categorical histogram."""
    spec_t, spec_j = _spec(treg), _spec(jreg)
    mt, mj = treg.metrics_init(spec_t), jreg.metrics_init(spec_j)
    _same(mt, mj)
    rng = np.random.default_rng(0)
    lat = np.array([0.0, 0.5, 0.50001, 1.0, 299.9, 300.0, 301.0, 1e9,
                    float("nan"), -3.0], np.float32)
    for step in range(4):
        ints = rng.permutation(EDGE_INTS)
        mask = rng.random(ints.shape) < 0.7
        codes = rng.integers(-1, 8, 10).astype(np.int32)   # out of range too
        mj = jreg.counter_add(spec_j, mj, "c.bytes", jnp.asarray(HALVES))
        mj = jreg.counter_add(spec_j, mj, "c.n", jnp.asarray(ints),
                              jnp.asarray(mask))
        mj = jreg.gauge_set(spec_j, mj, "g.level", jnp.int32(step * 7))
        mj = jreg.hist_observe(spec_j, mj, "h.lat", jnp.asarray(lat))
        mj = jreg.hist_observe(spec_j, mj, "h.code", jnp.asarray(codes),
                               jnp.asarray(codes != 3))
        if step % 2:
            mt = treg.counter_add(spec_t, mt, "c.bytes",
                                  torch.as_tensor(HALVES))
            mt = treg.counter_add(spec_t, mt, "c.n", torch.as_tensor(ints),
                                  torch.as_tensor(mask))
        else:
            mt = treg.counters_add(spec_t, mt, [
                ("c.bytes", torch.as_tensor(HALVES), None),
                ("c.n", torch.as_tensor(ints), torch.as_tensor(mask))])
        mt = treg.gauge_set(spec_t, mt, "g.level", torch.tensor(step * 7))
        mt = treg.hist_observe(spec_t, mt, "h.lat", torch.as_tensor(lat))
        mt = treg.hist_observe(spec_t, mt, "h.code", torch.as_tensor(codes),
                               torch.as_tensor(codes != 3))
        _same(mt, mj)
    assert treg.counter_value(mt, "c.n") == jreg.counter_value(mj, "c.n")
    merged_t = treg.metrics_merge(spec_t, mt, mt)
    merged_j = jreg.metrics_merge(spec_j, mj, mj)
    _same(merged_t, merged_j)
    assert treg.metrics_merge(spec_t, None, mt) is mt
    st, sj = (treg.metrics_summary(spec_t, merged_t),
              jreg.metrics_summary(spec_j, merged_j))
    assert json.dumps(st, sort_keys=True) == json.dumps(sj, sort_keys=True)


def test_lane_edges_and_categorical_counts_match_jax():
    for lane in (treg.histogram("a", 12, lo=1.0, hi=1024.0),
                 treg.histogram("b", 9, log=False)):
        jlane = jreg.Lane(*dataclasses.astuple(lane))
        assert treg.lane_edges(lane) == jreg.lane_edges(jlane)
    codes = np.array([[0, 5, 8, 9, -1], [3, 3, 8, 2, 11]], np.int32)
    mask = codes % 2 == 0
    for m in (None, mask):
        got = treg.categorical_counts(torch.as_tensor(codes), 9,
                                      None if m is None else
                                      torch.as_tensor(m))
        want = jreg.categorical_counts(jnp.asarray(codes), 9,
                                       None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q", [0.0, 1.0, 50.0, 95.0, 99.0, 100.0])
def test_percentile_from_hist_matches_jax(q):
    lane = treg.histogram("lat", 10, lo=0.5, hi=500.0)
    edges = treg.lane_edges(lane)
    for counts in ([0] * 10, [3, 0, 1, 7, 0, 0, 2, 0, 1, 4],
                   [0] * 9 + [5]):
        got = treg.percentile_from_hist(torch.tensor(counts), edges, q)
        want = jreg.percentile_from_hist(counts, edges, q)
        assert (got == want) or (math.isnan(got) and math.isnan(want))


def test_specs_refuse_duplicates_and_wrong_kinds():
    for pkg in (treg, jreg):
        with pytest.raises(ValueError, match="duplicate lane names"):
            pkg.MetricsSpec((pkg.counter("x"), pkg.gauge("x")))
        with pytest.raises(ValueError, match="duplicate lane names"):
            pkg.spec_union((pkg.counter("x"),), pkg.MetricsSpec(
                (pkg.counter("x"),)))
        with pytest.raises(ValueError, match=">= 2 bins"):
            pkg.histogram("h", 1)
        with pytest.raises(ValueError, match="lo < hi"):
            pkg.histogram("h", 4, lo=5.0, hi=1.0)
    spec = _spec(treg)
    m = treg.metrics_init(spec)
    with pytest.raises(ValueError, match="not a counter"):
        treg.counter_add(spec, m, "g.level", torch.ones(2))
    with pytest.raises(ValueError, match="twice"):
        treg.counters_add(spec, m, [("c.n", torch.ones(2), None)] * 2)
    with pytest.raises(KeyError, match="no lane"):
        treg.gauge_set(spec, m, "nope", torch.tensor(1))


def test_span_tracer_writes_a_chrome_trace(tmp_path):
    """The streamed driver opens one ``fleet.segment`` span per segment,
    each a child of the caller's span; the export is JSON that
    ``json.load`` reads back, and a disabled tracer records nothing."""
    from repro_torch.configs.seeker_har import HAR
    from repro_torch.core.recovery import init_generator
    from repro_torch.data.sensors import class_signatures, har_stream
    from repro_torch.models.har import har_init
    g = torch.Generator().manual_seed(0)
    params = har_init(g, HAR)
    wins, _ = har_stream(g, 5)
    kw = dict(signatures=class_signatures(), qdnn_params=params,
              host_params=params, gen_params=init_generator(g, 60, 3),
              har_cfg=HAR, device="cpu")
    harvest = torch.full((2, 5), 30.0)
    trace.clear()
    tfleet.seeker_fleet_simulate_streamed(wins, harvest, chunk=2, **kw)
    assert trace.events() == []
    trace.enable()
    try:
        with trace.span("outer", {"k": 1}):
            res = tfleet.seeker_fleet_simulate_streamed(wins, harvest,
                                                        chunk=2, **kw)
    finally:
        trace.enable(False)
    path = tmp_path / "trace.json"
    n_events = trace.export_chrome_trace(str(path))
    doc = json.load(open(path))
    assert n_events == len(doc["traceEvents"]) == len(trace.events())
    # the outer span and the segments; the engine's own spans inside them
    mine = [e for e in doc["traceEvents"]
            if e["name"] in ("outer", "fleet.segment")]
    assert len(mine) == 4 and mine[-1]["name"] == "outer"
    top = mine[-1]["args"]
    assert top["k"] == 1 and top["parent"] is None
    segs = mine[:3]
    assert [e["args"] for e in segs] == [
        {"start": a, "stop": b, "id": e["args"]["id"], "parent": top["id"]}
        for e, (a, b) in zip(segs, [(0, 2), (2, 4), (4, 5)])]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in mine)
    steps = [e for e in doc["traceEvents"] if e["name"] == "fleet.step"]
    assert [e["args"]["parent"] for e in steps] == [
        e["args"]["id"] for e in segs]
    assert res["n_chunks"] == 3
    trace.clear()
    assert trace.events() == []


# ---------------------------------------------------------------------------
# The lane registry mirrors the JAX one
# ---------------------------------------------------------------------------

# the node lane's exact byte total: one int64 in the port, an int32 pair in
# JAX (``bytes_on_wire_i32``)
RENAMED = {"bytes_on_wire_i32": "bytes_on_wire_exact"}
ACTIVE_SETS = (frozenset(), frozenset({"brownout"}),
               frozenset({"intermittent", "task", "task:2"}),
               frozenset({"brownout", "intermittent", "task", "task:3"}))


# the port's PRNG-key lane is on only with ``node_keys=`` (the generator
# and ``noise=`` sources carry no keys), and its keys are counter hashes,
# not ``fold_in``: its switch and its doc differ from the reference's
PRNG_OWN = {"config_kwarg": "node_keys"}


def test_fleet_lanes_mirror_jax():
    jax_lanes = jlanes.FLEET_LANES
    assert ([ln.name for ln in tlanes.FLEET_LANES]
            == [ln.name for ln in jax_lanes])
    assert tlanes.FleetCarry._fields == jlanes.FleetCarry._fields
    assert tlanes.FREEZE_KINDS == jlanes.FREEZE_KINDS
    for port, ref in zip(tlanes.FLEET_LANES, jax_lanes):
        for field in dataclasses.fields(ref):
            got, want = getattr(port, field.name), getattr(ref, field.name)
            if port.name == "prng" and field.name == "doc":
                assert "(seed, i)" in got
            elif port.name == "prng" and field.name in PRNG_OWN:
                assert (want, got) == (None, PRNG_OWN[field.name])
            elif field.name == "init":
                assert got == want.replace("repro.", "repro_torch.", 1)
            elif field.name == "aggregates":
                assert got == tuple(RENAMED.get(a, a) for a in want)
            elif field.name == "telemetry":
                for active in ACTIVE_SETS:
                    assert ([dataclasses.astuple(x) for x in got(active)]
                            == [dataclasses.astuple(x) for x in want(active)]
                            if want else got is None), (port.name, active)
            elif field.name == "telemetry_update":
                assert (got is None) == (want is None), port.name
            else:
                assert got == want, (port.name, field.name)
    for active in ACTIVE_SETS:
        assert (tlanes.fleet_trace_keys(active)
                == jlanes.fleet_trace_keys(active))
        assert (tlanes.fleet_counter_keys(active)
                == jlanes.fleet_counter_keys(active))
    assert tlanes.fleet_lane("task").freeze == "static"
    assert tlanes.fleet_lane("prng").carry_field == "keys"
    with pytest.raises(KeyError, match="registered"):
        tlanes.fleet_lane("rng")


@pytest.mark.parametrize("intermittent,n_tasks", [(False, 0), (True, 0),
                                                  (False, 2), (True, 3)])
def test_fleet_telemetry_spec_matches_jax(intermittent, n_tasks):
    got = repro_torch.fleet_telemetry_spec(intermittent, n_tasks)
    want = jfleet.fleet_telemetry_spec(intermittent, n_tasks)
    assert ([dataclasses.astuple(x) for x in got.lanes]
            == [dataclasses.astuple(x) for x in want.lanes])
    assert got is repro_torch.fleet_telemetry_spec(intermittent, n_tasks)
    assert (repro_torch.fleet_telemetry_spec(False)
            is repro_torch.fleet_telemetry_spec(False, 0))
