"""The port's span tracer (``repro_torch.obs.trace``) on the CPU: the off
path, spans under ``torch.profiler``, self times, the spans of the fleet
engine and the host tier, and the benchmark's readers of them
(``perfbench/metrics/*_ms_per_slot.py``).  No card, no JAX."""
import importlib.util
import itertools
import json
import sys
import tracemalloc
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the suite runs several test workers at once

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch import fleet_serve_step, seeker_fleet_simulate  # noqa: E402
from repro_torch.configs.seeker_har import HAR  # noqa: E402
from repro_torch.core.decision import IntermittentConfig  # noqa: E402
from repro_torch.core.energy import (BrownoutConfig,  # noqa: E402
                                     fleet_harvest_traces)
from repro_torch.core.recovery import init_generator  # noqa: E402
from repro_torch.data.sensors import class_signatures, har_stream  # noqa: E402
from repro_torch.host.server import (HostServeConfig,  # noqa: E402
                                     host_server_init)
from repro_torch.models.har import har_aux_init, har_init  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

FLEET_SPANS = {"fleet.step", "fleet.prepare", "fleet.slot", "fleet.noise",
               "fleet.corr", "fleet.sensor", "fleet.host", "fleet.carry",
               "fleet.aggregates"}
HOST_SPANS = {"host.serve_step", "host.encode", "host.ingest", "host.batch",
              "host.pop", "host.cache", "host.recover", "host.dnn",
              "host.ensemble", "host.telemetry", "host.finish"}
# each span's parent, as the slot bodies nest them
FLEET_PARENT = {"fleet.step": None, "fleet.prepare": "fleet.step",
                "fleet.slot": "fleet.step", "fleet.noise": "fleet.slot",
                "fleet.corr": "fleet.slot", "fleet.sensor": "fleet.slot",
                "fleet.intermittent": "fleet.slot",
                "fleet.host": "fleet.slot", "fleet.carry": "fleet.slot",
                "fleet.aggregates": "fleet.step"}
HOST_PARENT = {"host.serve_step": None, "host.encode": "host.serve_step",
               "host.batch": "host.serve_step", "host.pop": "host.batch",
               "host.recover": "host.batch", "host.dnn": "host.batch",
               "host.finish": "host.batch"}
# the readers: each metric's spans and the span that counts its slots
READERS = {
    "fleet.edge_ms_per_slot": (("fleet.noise", "fleet.corr", "fleet.sensor",
                                "fleet.intermittent"), "fleet.slot"),
    "fleet.host_ms_per_slot": (("fleet.host",), "fleet.slot"),
    "fleet.lanes_ms_per_slot": (("fleet.carry", "fleet.slot"), "fleet.slot"),
    "fleet.call_ms_per_slot": (("fleet.step", "fleet.prepare",
                                "fleet.aggregates"), "fleet.slot"),
    "host.encode_ms_per_slot": (("host.serve_step", "host.encode"),
                                "host.serve_step"),
    "host.queue_ms_per_slot": (("host.ingest", "host.pop"),
                               "host.serve_step"),
    "host.serve_ms_per_slot": (("host.batch", "host.cache", "host.recover",
                                "host.dnn", "host.ensemble", "host.finish"),
                               "host.serve_step"),
    "host.telemetry_ms_per_slot": (("host.telemetry",), "host.serve_step"),
}


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts and ends with the tracer off and empty."""
    trace.enable(False)
    trace.clear()
    yield
    trace.enable(False)
    trace.clear()


def _by_id(evs):
    return {e["id"]: e for e in evs}


def _parent_names(evs):
    """{name: the set of its parents' names} over ``evs``."""
    ids = _by_id(evs)
    out = {}
    for e in evs:
        parent = ids[e["parent"]]["name"] if e["parent"] is not None else None
        out.setdefault(e["name"], set()).add(parent)
    return out


def _equal(a, b) -> bool:
    """Bitwise equality of two results (tensors, NamedTuples, dicts)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

def test_off_span_is_a_shared_null_context(monkeypatch):
    """Off (no ``enable()``, no profiler), a span is one shared object:
    no clock read, no ``record_function``, no event, and no allocation
    beyond what a call of a no-op function makes."""
    def boom(*_):
        raise AssertionError("an off span touched the clock or profiler")

    monkeypatch.setattr(trace, "_clock", boom)
    monkeypatch.setattr(trace._profiler, "record_function", boom)
    off = trace.span("fleet.slot", {"slot": 3})
    assert off is trace.span("host.batch")
    with trace.span("fleet.noise") as inside:
        assert inside is None
    assert trace.events() == []

    def noop(name):
        return None

    def peak(fn):
        tracemalloc.start()
        try:
            fn("fleet.slot")
            tracemalloc.reset_peak()
            before = tracemalloc.get_traced_memory()[0]
            for _ in itertools.repeat(None, 1000):
                fn("fleet.slot")
            now, top = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        return now - before, top - before

    kept, top = peak(trace.span)
    assert kept == 0
    assert top <= peak(noop)[1]


def test_enabled_spans_nest_and_export(tmp_path):
    """Under ``enable()``: one event per span, parents by id, host ints in
    ``args``; the Chrome export carries them with the base time."""
    trace.enable()
    with trace.span("a", {"n": 2}):
        with trace.span("b"):
            pass
        with trace.span("c"):
            with trace.span("d"):
                pass
    trace.enable(False)
    with trace.span("off"):
        pass
    evs = trace.events()
    assert [e["name"] for e in evs] == ["b", "d", "c", "a"]
    ids = {e["name"]: e["id"] for e in evs}
    assert [e["parent"] for e in evs] == [ids["a"], ids["c"], ids["a"], None]
    assert evs[-1]["args"] == {"n": 2}
    a = evs[-1]
    for e in evs[:-1]:
        assert a["ts"] <= e["ts"] and e["ts"] + e["dur"] <= a["ts"] + a["dur"]
    path = tmp_path / "spans.json"
    assert trace.export_chrome_trace(str(path)) == 4
    doc = json.loads(path.read_text())
    assert doc["baseTimeNanoseconds"] == trace.BASE_NS
    assert [e["args"]["parent"] for e in doc["traceEvents"]] == [
        e["parent"] for e in evs]
    assert all(e["ph"] == "X" for e in doc["traceEvents"])


def test_profiler_turns_spans_on_as_user_annotations(tmp_path):
    """A recording ``torch.profiler`` makes the spans live with no
    ``enable()``: each is a ``user_annotation`` of the profiler's trace,
    and the buffer's event lies inside it on the same clock."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("fleet.step", {"nodes": 4, "slots": 2}):
            with trace.span("fleet.slot", {"slot": 0}):
                with trace.span("fleet.corr"):
                    torch.ones(8).sum()
    with trace.span("after"):
        pass
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    notes = {e["name"]: e for e in doc["traceEvents"]
             if e.get("cat") == "user_annotation"}
    evs = trace.events()
    assert [e["name"] for e in evs] == ["fleet.corr", "fleet.slot",
                                        "fleet.step"]
    assert _parent_names(evs) == {"fleet.corr": {"fleet.slot"},
                                  "fleet.slot": {"fleet.step"},
                                  "fleet.step": {None}}
    shift = (doc["baseTimeNanoseconds"] - trace.BASE_NS) / 1e3
    slack = 1e3     # µs: two conversions of one monotonic clock to Unix time
    for e in evs:
        note = notes[e["name"]]
        assert note["ts"] + shift - slack <= e["ts"]
        assert e["ts"] + e["dur"] <= note["ts"] + note["dur"] + shift + slack


def test_self_times_subtract_the_union_of_children():
    """Self time: a span's duration less the union of its children's
    intervals; counts and times add up by name."""
    evs = [
        {"name": "step", "ts": 0.0, "dur": 100.0, "id": 1, "parent": None},
        {"name": "slot", "ts": 10.0, "dur": 40.0, "id": 2, "parent": 1},
        {"name": "noise", "ts": 12.0, "dur": 5.0, "id": 3, "parent": 2},
        {"name": "host", "ts": 20.0, "dur": 25.0, "id": 4, "parent": 2},
        {"name": "slot", "ts": 55.0, "dur": 30.0, "id": 5, "parent": 1},
        {"name": "host", "ts": 60.0, "dur": 10.0, "id": 6, "parent": 5},
        # overlapping children are covered once
        {"name": "x", "ts": 200.0, "dur": 10.0, "id": 7, "parent": None},
        {"name": "y", "ts": 201.0, "dur": 5.0, "id": 8, "parent": 7},
        {"name": "y", "ts": 204.0, "dur": 4.0, "id": 9, "parent": 7},
    ]
    got = trace.self_times(evs)
    assert got == {"step": (1, 30.0), "slot": (2, 10.0 + 20.0),
                   "noise": (1, 5.0), "host": (2, 35.0), "x": (1, 3.0),
                   "y": (2, 9.0)}
    # the step's tree tiles its 100 µs
    assert sum(got[k][1] for k in ("step", "slot", "noise", "host")) == 100.0


# ---------------------------------------------------------------------------
# The spans of the fleet engine and the host tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    params = har_init(g, HAR)
    return dict(params=params, aux=har_aux_init(g, HAR),
                gen=init_generator(g, HAR.window, HAR.channels),
                windows=har_stream(g, 3 * 4)[0].reshape(4, 3, 60, 3))


def _traced(fn):
    """``fn()`` with tracing off, then on: both results and the events."""
    off = fn()
    trace.enable()
    try:
        on = fn()
    finally:
        trace.enable(False)
    return off, on, trace.events()


@pytest.mark.parametrize("lane", ["brownout", "intermittent"])
def test_fleet_engine_spans(model, lane):
    """``seeker_fleet_simulate`` at 4 nodes in node blocks of 2, 3 slots:
    every span at its place, one ``fleet.slot`` per slot and one block span
    per node block, and the result bitwise that of an untraced run."""
    n, s = 4, 3
    harvest = fleet_harvest_traces(torch.Generator().manual_seed(1), n, s)
    lanes = (dict(brownout=BrownoutConfig(off_uj=6.0, restart_uj=30.0),
                  initial_uj=12.0) if lane == "brownout" else
             dict(intermittent=IntermittentConfig(1, 0.0),
                  aux_params=model["aux"], initial_uj=12.0))

    def run():
        return seeker_fleet_simulate(
            model["windows"], harvest * 0.1, signatures=class_signatures(),
            qdnn_params=model["params"], host_params=model["params"],
            gen_params=model["gen"], har_cfg=HAR, node_keys=torch.tensor(
                [[i, 7] for i in range(n)], dtype=torch.int64),
            node_block=2, telemetry=True, device="cpu", **lanes)

    off, on, evs = _traced(run)
    assert _equal(off, on)
    names = {e["name"] for e in evs}
    want = FLEET_SPANS | ({"fleet.intermittent"} if lane == "intermittent"
                          else set())
    assert names == want
    counts = {k: v[0] for k, v in trace.self_times(evs).items()}
    assert counts["fleet.step"] == counts["fleet.prepare"] == 1
    assert counts["fleet.slot"] == s
    blocks = 2
    for name in ("fleet.corr", "fleet.sensor", "fleet.host"):
        assert counts[name] == s * blocks
    assert counts["fleet.noise"] == counts["fleet.carry"] == s
    parents = _parent_names(evs)
    assert parents == {k: {v} for k, v in FLEET_PARENT.items()
                       if k in names}
    step = next(e for e in evs if e["name"] == "fleet.step")
    assert step["args"] == {"nodes": n, "slots": s}
    assert [e["args"]["slot"] for e in evs if e["name"] == "fleet.slot"] == [
        0, 1, 2]
    # the spans tile the step: self times add up to its duration
    assert sum(t for _, t in trace.self_times(evs).values()) == \
        pytest.approx(step["dur"], rel=1e-6, abs=1e-3)


def test_host_serve_step_spans(model):
    """``fleet_serve_step`` queue mode, 10 nodes in batches of 4, telemetry
    on: every span at its place, one ``host.batch`` per microbatch, and the
    result bitwise that of an untraced run."""
    n = 10
    cfg = HostServeConfig(channels=3, k=12, m=20, t=60, n_classes=12,
                          n_nodes=n, batch_size=4, queue_capacity=16,
                          cache_capacity=16, telemetry=True)
    wins = model["windows"].reshape(-1, 60, 3)[:n]
    alive = torch.arange(n) % 5 != 0

    def run():
        state = host_server_init(cfg, "cpu")
        outs = []
        for _ in range(2):
            res = fleet_serve_step(
                wins, host_params=model["params"], har_cfg=HAR, k=12,
                host_state=state, serve_cfg=cfg, gen_params=model["gen"],
                alive=alive, seed=3, device="cpu")
            state = res["host_state"]
            outs.append(res)
        return outs

    off, on, evs = _traced(run)
    assert _equal(off, on)
    assert {e["name"] for e in evs} == HOST_SPANS
    counts = {k: v[0] for k, v in trace.self_times(evs).items()}
    batches = -(-n // cfg.batch_size)
    assert counts["host.serve_step"] == 2
    for name in ("host.batch", "host.pop", "host.recover", "host.dnn"):
        assert counts[name] == 2 * batches
    parents = _parent_names(evs)
    for name, parent in HOST_PARENT.items():
        assert parents[name] == {parent}, name
    assert parents["host.cache"] == parents["host.ensemble"] == {"host.batch"}
    # the first microbatch's span holds the slot's ingest, the last its
    # backlog telemetry and finish
    assert parents["host.telemetry"] == {"host.batch"}
    assert parents["host.ingest"] == {"host.serve_step", "host.batch"}
    first = [e for e in evs if e["name"] == "host.batch"][:batches]
    assert [e["args"]["batch"] for e in first] == list(range(batches))
    step = next(e for e in evs if e["name"] == "host.serve_step")
    assert step["args"] == {"nodes": n, "k": 12}


# ---------------------------------------------------------------------------
# The benchmark's readers of the spans
# ---------------------------------------------------------------------------

class _Run:
    """The one field of ``perfbench.harness.Run`` the readers look at."""
    trace = {"busy_s": 0.0}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _buffer(slot_span: str, slots: int) -> tuple:
    """A hand-made buffer: ``slots`` slot spans, each with one child of
    every other span name, child ``i`` lasting ``2**i`` µs, and the slot
    span ``2**len(names)`` µs of self time: every set of names has its own
    sum.  Returns the events and each name's self time a slot."""
    names = sorted({n for names, _ in READERS.values() for n in names}
                   - {slot_span})
    took = {name: 2.0 ** i for i, name in enumerate(names)}
    took[slot_span] = 2.0 ** len(names)
    evs, ids = [], itertools.count(1)
    for k in range(slots):
        sid, t0 = next(ids), k * 2.0 ** (len(names) + 2)
        at = t0
        for name in names:
            evs.append({"name": name, "ts": at, "dur": took[name],
                        "id": next(ids), "parent": sid, "args": {}})
            at += took[name]
        evs.append({"name": slot_span, "ts": t0, "dur": at - t0 +
                    took[slot_span], "id": sid, "parent": None, "args": {}})
    return evs, took


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers_per_slot(metric, monkeypatch):
    """Each reader sums its spans' self times per slot span, in ms; it
    reads nothing without the spans, without the tracer's ``self_times``,
    or in an untraced run."""
    spans, slot_span = READERS[metric]
    read = _reader(metric)
    slots = 4
    evs, took = _buffer(slot_span, slots)
    monkeypatch.setattr(trace, "events", lambda: evs)
    assert read(_Run()) == sum(took[n] for n in spans) / 1e3

    class Untraced:
        trace = None

    assert read(Untraced()) is None
    monkeypatch.setattr(trace, "events", lambda: [])
    assert read(_Run()) is None
    others = [e for e in evs if e["name"] not in spans]
    monkeypatch.setattr(trace, "events", lambda: others)
    assert read(_Run()) is None
    # a program whose tracer has no self_times (the parent's)
    monkeypatch.delattr(trace, "self_times")
    monkeypatch.setattr(trace, "events", lambda: evs)
    assert read(_Run()) is None


def test_span_readers_split_each_step_once():
    """Every fleet and host span name belongs to exactly one reader, so a
    cell's readers add up to its step spans with nothing counted twice."""
    fleet = [n for m, (ns, _) in READERS.items() if m.startswith("fleet.")
             for n in ns]
    host = [n for m, (ns, _) in READERS.items() if m.startswith("host.")
            for n in ns]
    assert sorted(fleet) == sorted(FLEET_SPANS | {"fleet.intermittent"})
    assert sorted(host) == sorted(HOST_SPANS)
