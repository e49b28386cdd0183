"""A run with the timed path broken underneath reads ``correct: false``.

Drives the rest of a run (set-up, window, the check against the plain
reference) on the CPU, at 24 nodes and a 16-slot pool, skipping only the
harness's look for a card, once clean and once for each fault the cell
can have:

* ``state_unchanged``: each step hands back the state it was given (the
  fleet's node state, keys and brown-out flags; the host server's
  queue, cache, clock and counters);
* ``half_batch``: the fleet computes half the nodes and hands the first
  half's results to the other half too; the host serves half the frames;
* ``answer_altered``: the host's logits are altered where they are made
  (times 1.01).

Every cell runs on one chip, so none has an exchange between chips to
leave out.  Run by path:

    python3 -m perfbench.checks.faults [--workload har-fleet ...]
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench.harness import execute, find_cell  # noqa: E402

ROW_KEYS = ("decisions", "payload_bytes", "stored_uj", "k_trace", "logits",
            "preds", "alive", "brownout")


@contextlib.contextmanager
def patched(module, name: str, fn):
    real = getattr(module, name)
    setattr(module, name, fn(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def state_unchanged(real):
    def step(*args, **kw):
        res = real(*args, **kw)
        if kw.get("state0") is not None:
            res["final_state"] = kw["state0"]
            res["final_keys"] = kw["node_keys"]
            res["final_brownout"] = kw["brownout_state0"]
        return res
    return step


def half_batch(real):
    import torch

    def copy_half(x):
        h = x.shape[0] // 2
        return torch.cat([x[:x.shape[0] - h], x[:h]])

    def step(*args, **kw):
        res = real(*args, **kw)
        for k in ROW_KEYS:
            res[k] = copy_half(res[k].transpose(0, 1)).transpose(0, 1)
        st = res["final_state"]
        res["final_state"] = type(st)(
            stored_uj=copy_half(st.stored_uj),
            predictor=type(st.predictor)(*(copy_half(x)
                                           for x in st.predictor)),
            prev_label=copy_half(st.prev_label))
        res["final_keys"] = copy_half(res["final_keys"])
        res["final_brownout"] = copy_half(res["final_brownout"])
        return res
    return step


def host_state_unchanged(real):
    def step(*args, **kw):
        res = real(*args, **kw)
        res["host_state"] = kw["host_state"]
        return res
    return step


def host_half_batch(real):
    import torch

    def step(windows, **kw):
        n = windows.shape[0]
        half = torch.arange(n, device=windows.device) < n // 2
        kw["engine_alive"] = kw["engine_alive"] & half
        return real(windows, **kw)
    return step


def answer_altered(real):
    def altered(*args, **kw):
        return real(*args, **kw) * 1.01
    return altered


def one_run(name: str, seed: int):
    import torch
    cell = find_cell(name)
    cell.mix["pool_slots"] = 16
    result, numbers = execute(cell, seed, 0.5, False, time.perf_counter(),
                              torch.device("cpu"), nodes=24)
    return result["correct"], result["compared"]


def faults_of(entry: str) -> dict:
    """Each fault: (module, attribute, wrapper of the attribute)."""
    import repro_torch
    import repro_torch.host.server as server_mod
    import repro_torch.serving.fleet as fleet_mod
    if entry == "fleet":
        return {"state_unchanged": (repro_torch, "seeker_fleet_simulate",
                                    state_unchanged),
                "half_batch": (repro_torch, "seeker_fleet_simulate",
                               half_batch),
                "answer_altered": (fleet_mod, "seeker_host_step",
                                   answer_altered)}
    if entry == "host":
        return {"state_unchanged": (repro_torch, "fleet_serve_step",
                                    host_state_unchanged),
                "half_batch": (repro_torch, "fleet_serve_step",
                               host_half_batch),
                "answer_altered": (server_mod, "har_apply", answer_altered)}
    raise ValueError(f"no faults listed for entry {entry!r}")


def main(argv=None) -> int:
    from perfbench.harness import ROOT as root, load_json
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", action="append")
    args = p.parse_args(argv)
    cells = args.workload or [w["name"] for w in
                              load_json(root / "BENCHMARK.json")["workloads"]]
    failures = []
    for name in cells:
        faults = faults_of(find_cell(name).spec["entry"])
        ok, compared = one_run(name, 4_000_000_007)
        print(f"{name} clean: correct={ok} {compared}")
        if not ok:
            failures.append((name, "clean"))
        for fault, (module, attr, fn) in faults.items():
            with patched(module, attr, fn):
                ok, compared = one_run(name, 4_000_000_007)
            print(f"{name} {fault}: correct={ok} {compared}")
            if ok:
                failures.append((name, fault))
    if failures:
        print(f"faults check FAILED: {failures}")
        return 1
    print("faults check: every clean run correct, every faulty run not")
    return 0


if __name__ == "__main__":
    sys.exit(main())
