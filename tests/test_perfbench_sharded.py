"""The benchmark's ``fleet_sharded`` entry (``perfbench/entries/
fleet_sharded.py``) on 4 gloo CPU ranks: the cell ``har-fleet-sharded-4chip``
at 24 nodes, 2 steps of 8 slots.

One subprocess is rank 0, as the harness's process is on the card; the entry
starts ranks 1-3 itself and they meet in a ``FileStore`` under ``tmp_path``
(the entry makes its store directory under ``TMPDIR``).  The first step runs
with the span tracer on, the second under a CPU ``torch.profiler``, which
the other ranks follow.  Every rank runs one thread, as the single-device
run it is held to does (the CPU convolutions split their sums by thread
count).  Asserted: the kept steps inside the cell's limits against the
plain reference; bitwise equal to the single-device ``fleet`` entry's on
the same seed, in node blocks of the tiles' size; ``collective_counts()``
equal to the calls and bytes reckoned from the result's shapes;
``fleet.tile`` and ``fleet.collect`` recorded; no JAX or ``repro`` loaded;
the store removed.  No JAX.

On a card (``-m cuda``; it skips without one) the same checks run the
entry at world size 1 on NCCL at the cell's 3000 nodes a card: the
configuration's mesh cut to one rank by the test, the program untouched."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2

# rank 0: argv[1] is [repo root, device, nodes, mesh or None, steps]
_RANK0 = textwrap.dedent("""
    import json, sys, torch
    from pathlib import Path
    ROOT, DEV, N, MESH, STEPS = json.loads(sys.argv[1])
    sys.path[:0] = [ROOT, ROOT + "/src"]
    ENTRIES = Path(ROOT) / "perfbench" / "entries"
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile
    from perfbench.harness import (Context, find_cell, forbidden_modules,
                                   judge, load_module, setup_entry)
    from repro_torch import seeker_fleet_simulate, sharding
    from repro_torch.obs import trace
    from repro_torch.serving.fleet_lanes import fleet_trace_keys

    # the aggregates a bare keyed fleet all-reduces
    AGGREGATES = ("bytes_on_wire", "bytes_on_wire_exact",
                  "decision_histogram", "completed", "alive_slots",
                  "brownout_slots", "brownout_events")

    cell = find_cell("har-fleet-sharded-4chip")
    cell.mix["pool_slots"] = 16
    if MESH is not None:
        cell.config["mesh"] = MESH
    ctx = Context(cell, 2 ** 31 + 7, torch.device(DEV), N)
    sut = setup_entry(ctx)
    before = sharding.collective_counts()
    trace.enable()
    sut.step()
    trace.enable(False)
    with profile(activities=[ProfilerActivity.CPU]):
        sut.step()
    counts = sharding.collective_counts()
    spans = sorted(trace.self_times(trace.events()))
    world = sut.world
    sut.release()
    if DEV.startswith("cuda"):
        torch.cuda.synchronize()
    numbers = sut.check()
    correct, _ = judge(numbers, cell.limits)

    fleet = load_module(ENTRIES / "fleet.py", "fleet_entry")
    one = fleet.FleetCell(ctx)
    one.kwargs["node_block"] = N // world      # the tiles' block shape
    for _ in range(STEPS):
        one.step()
    bitwise = (len(one.kept) == len(sut.kept) == STEPS
               and one.layout == sut.layout
               and all(torch.equal(a, b) for a, b in zip(one.kept, sut.kept)))

    def leaves(x):
        if isinstance(x, tuple):
            return [v for f in x for v in leaves(f)]
        return [x]

    # each rank's part of every collective, from one call's result shapes
    res = seeker_fleet_simulate(one.windows[:, :8], one.harvest[:, :8],
                                node_keys=one.keys0, **one.kwargs)
    tile = N // world
    traces = [res[k] for k in fleet_trace_keys(frozenset()) if k != "preds"]
    carry = leaves(res["final_state"]) + [res["final_keys"],
                                          res["final_brownout"]]
    gather = ([x.numel() // x.shape[1] * tile * x.element_size()
               for x in traces]
              + [x.numel() // x.shape[0] * tile * x.element_size()
                 for x in carry])
    aggs = [res[k] for k in AGGREGATES]
    reduce = sum(a.numel() * (4 if a.is_floating_point() else 8)
                 for a in aggs)
    print(json.dumps({
        "correct": correct, "numbers": numbers, "bitwise": bitwise,
        "world": world, "spans": spans, "forbidden": forbidden_modules(),
        "counts": {k: {f: counts[k][f] - before[k][f] for f in counts[k]}
                   for k in counts},
        "expect": {"all_gather": {"calls": STEPS * len(gather),
                                   "bytes": STEPS * sum(gather)},
                   "all_reduce": {"calls": STEPS * 2,
                                   "bytes": STEPS * reduce},
                   "point_to_point": {"calls": 0, "bytes": 0}}}))
""")


def _rank0(tmp_path, dev: str, n: int, mesh) -> dict:
    """Run rank 0 in a process of its own; its result line."""
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    args = json.dumps([str(ROOT), dev, n, mesh, STEPS])
    out = subprocess.run([sys.executable, "-c", _RANK0, args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _assert_sound(got: dict, world: int, n: int, tmp_path) -> None:
    assert got["world"] == world
    assert got["correct"], got["numbers"]
    assert got["numbers"]["node_steps"] == STEPS * min(n, 64)
    assert got["bitwise"], "the sharded steps differ from the single-device"
    assert got["counts"] == got["expect"]
    assert {"fleet.tile", "fleet.collect"} <= set(got["spans"])
    assert got["forbidden"] == []
    assert not list(tmp_path.glob("perfbench-sharded-*"))


def test_sharded_entry_on_four_gloo_ranks(tmp_path):
    _assert_sound(_rank0(tmp_path, "cpu", 24, None), 4, 24, tmp_path)


@pytest.fixture
def one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_sharded_entry_world_one_on_nccl(one_card, tmp_path):
    """The entry's own NCCL path on one card: world size 1, 3000 nodes."""
    got = _rank0(tmp_path, "cuda:0", 3000, {"data": 1})
    _assert_sound(got, 1, 3000, tmp_path)
