"""Readings the limits of a cell's compared numbers are set from.

For each seed: set up the cell, run ``--steps`` steps of the timed path
(as many as one run's window makes), then read the compared numbers of the
program against the plain reference (the lower readings) and, on the
first ``--control-seeds`` seeds, of the control against the same
reference: the reference itself computed with TF32 operands, one
precision below the configurations' float32 (the upper readings).

On the card, at the cell's own size:

    python3 -m perfbench.checks.control --workload har-fleet --steps 420

As a test on the CPU, at a size a test run holds, it asserts that the
program reads inside the cell's limits and the control outside them:

    python3 -m perfbench.checks.control --workload har-fleet --cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench.harness import Context, find_cell, setup_entry  # noqa: E402

BASE_SEED = 3_000_000_019


def readings(name: str, seeds: list[int], steps: int, control_seeds: int,
             dev, nodes: int | None = None, pool: int | None = None) -> list:
    import torch
    rows = []
    for i, seed in enumerate(seeds):
        cell = find_cell(name)
        if pool is not None:
            cell.mix["pool_slots"] = pool
        t0 = time.perf_counter()
        sut = setup_entry(Context(cell, seed, dev, nodes))
        for _ in range(steps):
            sut.step()
        t1 = time.perf_counter()
        sut.release()
        row = {"seed": seed, "steps": steps,
               "step_ms": (t1 - t0) / steps * 1e3,
               "program": sut.check()}
        if i < control_seeds:
            row["control"] = sut.check(control=True)
        row["check_s"] = time.perf_counter() - t1
        rows.append(row)
        print(json.dumps(row), flush=True)
        del sut
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def summary(name: str, rows: list) -> dict:
    limits = find_cell(name).limits
    out = {}
    for k in limits:
        low = max(r["program"][k] for r in rows)
        up = [r["control"][k] for r in rows if "control" in r]
        out[k] = {"lower": low, "upper": min(up) if up else None,
                  "limit": limits[k]}
    return out


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--steps", type=int, default=420)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--cpu", action="store_true",
                   help="the test: 24 nodes, a 16-slot pool, 4 seeds")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cpu:
        rows = readings(args.workload, [BASE_SEED + i for i in range(4)], 4,
                        4, torch.device("cpu"), nodes=24, pool=16)
    else:
        rows = readings(args.workload,
                        [BASE_SEED + 7919 * i for i in range(args.seeds)],
                        args.steps, args.control_seeds,
                        torch.device("cuda", 0))
    table = summary(args.workload, rows)
    print(json.dumps({"workload": args.workload, "summary": table}))
    if args.cpu:
        for k, v in table.items():
            assert v["lower"] <= v["limit"], (k, v)
        assert any(v["upper"] > v["limit"] for v in table.values()), table
        print(f"control check {args.workload}: the program inside every "
              f"limit, the control outside one")
    return 0


if __name__ == "__main__":
    sys.exit(main())
