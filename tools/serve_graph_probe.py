#!/usr/bin/env python3
"""How the host serve slot runs in the benchmark's ``har-host-serve`` cell,
for one tree of the repository on one card: its CUDA graphs' counts, the
device memory they hold, and the host cost of a replay under the profiler.

    python3 tools/serve_graph_probe.py <src dir> [--seconds S] [--seed N]

Loads the ``repro_torch`` under the ``src`` directory given and this
checkout's ``perfbench/``, sets the cell up as ``perfbench.run`` does (TF32
off, the spec's warm-up steps), runs a window of ``--seconds`` (50, the
benchmark's) and prints one JSON line:

* ``counts``: ``serve_graph_counts()`` after the warm-up and after the
  window, and the window's captures, replays a slot and eager segments
  (absent on a tree without the graphs);
* ``memory``: allocated and reserved bytes after set-up and after the
  warm-up, ``max_memory_allocated`` over the window (what the benchmark's
  ``peak_mem_gib`` reads), and the bytes the caching allocator reserves in
  pools other than its default one (the graphs' private pools);
* ``host_ms`` (graph trees only): the median host time of each graph's
  replay call, of one ``counter_noise`` call on a microbatch's signatures
  and of one step, with no profiler, under a CPU-only ``torch.profiler``
  and under a CPU and CUDA one (CUDA activity tracing).

Compare two trees in turns within one call on the card, for example a
parent unpacked with ``git archive`` into ``parent_check/``:

    for s in parent_check/src src; do
        python3 tools/serve_graph_probe.py $s; done
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def private_pool_bytes(torch) -> int:
    """Bytes reserved in segments of pools other than the default one."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))


def memory(torch) -> dict:
    torch.cuda.synchronize()
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "private_pools": private_pool_bytes(torch)}


def host_ms(torch, fn, n: int = 10) -> float:
    """Median host time of ``fn``'s call, the device idle before each."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src")
    p.add_argument("--seconds", type=float, default=50.0)
    p.add_argument("--seed", type=int, default=3100000201)
    args = p.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness import Context, find_cell, setup_entry
    from repro_torch.host import server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    cell = find_cell("har-host-serve")
    counts = getattr(server, "serve_graph_counts", None)
    sut = setup_entry(Context(cell, args.seed, torch.device("cuda", 0)))
    out = {"card": torch.cuda.get_device_name(0), "src": args.src,
           "memory": {"after_setup": memory(torch)}}
    for _ in range(cell.spec["warmup_steps"]):
        sut.step()
    out["memory"]["after_warmup"] = memory(torch)
    torch.cuda.reset_peak_memory_stats()
    before = counts() if counts else None
    steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        sut.step()
        steps += 1
    torch.cuda.synchronize()
    out["window"] = {"steps": steps, "s": time.perf_counter() - t0}
    out["memory"]["window_peak_allocated"] = torch.cuda.max_memory_allocated()
    out["memory"]["after_window"] = memory(torch)
    if counts:
        after = counts()
        slots = steps * sut.slots_per_step
        out["counts"] = {
            "after_warmup": before, "after_window": after,
            "window_captures": after["captures"] - before["captures"],
            "window_eager_segments": (after["eager_segments"]
                                      - before["eager_segments"]),
            "replays_per_slot": (after["replays"] - before["replays"])
            / slots}
        slot_graphs = next(iter(server._GRAPHS.values()))
        graphs, cfg = slot_graphs.graphs, sut.serve_cfg
        any_sigs = slot_graphs.sigs[0].clone()

        def readings():
            return {"replay": [host_ms(torch, g.replay) for g in graphs],
                    "noise": host_ms(torch, lambda: server.counter_noise(
                        any_sigs, seed=1, channels=cfg.channels, t=cfg.t)),
                    "step": host_ms(torch, sut.step)}

        out["host_ms"] = {"plain": readings()}
        for name, acts in (("cpu_profiler", [ProfilerActivity.CPU]),
                           ("cuda_profiler", [ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])):
            with profile(activities=acts):
                out["host_ms"][name] = readings()
    sut.release()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
