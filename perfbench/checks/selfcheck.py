"""CPU self-checks of the benchmark, run by path (pytest does not collect
this file):

    python3 -m perfbench.checks.selfcheck

1. ``BENCHMARK.json`` keeps to the contract's names, units and keys.
2. A cell, a configuration, a traffic mix and a metric added as new files,
   with new entries in a copy of ``BENCHMARK.json``, are found and run
   with no edit to a file that is there.
3. Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
   ``flax`` or ``repro`` (whole names: ``repro_torch`` is the port), and
   the reference loads nothing of ``repro_torch``.
4. The reference agrees with the port (``device="cpu"``) on every cell at
   24 nodes, inside the cell's limits.
5. In a directory that holds only ``BENCHMARK.json`` and ``perfbench/`` a
   run exits with another code than 0 and prints nothing on standard
   output.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench.harness import execute, find_cell, load_json  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_contract(bench: dict) -> None:
    assert set(bench) == KEYS["top"], set(bench) ^ KEYS["top"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            extra = set(e) - KEYS[kind] - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            assert set(e) >= KEYS[kind] and not extra, (kind, e)
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher"), e
            for key in ("why", "layer"):
                assert key not in e or _line(e[key]), (e["name"], key)
            assert kind != "configs" or _line(e["source"]), e["name"]
    assert len(names) == len(set(names)), "a name is used twice"
    cfg_names = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert w["config"] in cfg_names and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(bench)) <= 64 * 1024
    print("contract: names, units and keys as the contract allows")


def check_discovery() -> None:
    """New files and entries, no edit to an existing file."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        bench = load_json(ROOT / "BENCHMARK.json")
        before = {p: p.read_bytes() for p in (tmp / "perfbench").rglob("*")
                  if p.is_file()}
        pb = tmp / "perfbench"
        cfg = load_json(pb / "configs" / "seeker-har.json")
        cfg["name"] = "seeker-har-copy"
        (pb / "configs" / "seeker-har-copy.json").write_text(json.dumps(cfg))
        mix = load_json(pb / "mixes" / "typical.json")
        mix["harvest_scale"] = 0.5
        (pb / "mixes" / "half-harvest.json").write_text(json.dumps(mix))
        spec = load_json(pb / "workloads" / "har-fleet.json")
        (pb / "workloads" / "new-cell.json").write_text(json.dumps(spec))
        (pb / "metrics" / "window_steps.py").write_text(
            "def read(run):\n    return run.window_steps\n")
        bench["configs"].append(dict(bench["configs"][0],
                                     name="seeker-har-copy",
                                     file="perfbench/configs/seeker-har-copy.json"))
        bench["workloads"].append({"name": "new-cell",
                                   "config": "seeker-har-copy",
                                   "traffic": "half-harvest", "chips": 1,
                                   "why": "a cell added as files"})
        bench["end_to_end"].append({"name": "window_steps", "unit": "steps",
                                    "better": "higher", "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": ["new-cell"]})
        (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
        code = (
            "import sys, time, json, torch\n"
            f"sys.path[:0] = [{str(tmp)!r}, {str(ROOT / 'src')!r}]\n"
            "from perfbench.harness import find_cell, execute\n"
            "cell = find_cell('new-cell')\n"
            "cell.mix['pool_slots'] = 16\n"
            "r, _ = execute(cell, 5, 0.3, False, time.perf_counter(),\n"
            "               torch.device('cpu'), nodes=16)\n"
            "print(json.dumps(r))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], result
        assert "window_steps" in result["metrics"], result["metrics"]
        after = {p: p.read_bytes() for p in before}
        assert after == before, "an existing file changed"
    print("discovery: a new cell, configuration, mix and metric ran as "
          "new files only")


def check_imports() -> None:
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import perfbench.run\n"
        "from perfbench.harness import find_cell, execute, forbidden_modules\n"
        "cell = find_cell('har-fleet'); cell.mix['pool_slots'] = 16\n"
        "execute(cell, 3, 0.2, False, time.perf_counter(),\n"
        "        torch.device('cpu'), nodes=8)\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    ref = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
           "import perfbench.reference.seeker, perfbench.traffic.sensors\n"
           "print(sorted({m.split('.')[0] for m in sys.modules}\n"
           "             & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", ref], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]", (out.stdout, out.stderr[-2000:])
    print("imports: a run loads no jax, jaxlib, flax or repro; the reference "
          "and the generators load no repro_torch")


def check_cells() -> None:
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = find_cell(w["name"])
        cell.mix["pool_slots"] = 16
        result, numbers = execute(cell, 2 ** 31 + 11, 0.5, False,
                                  time.perf_counter(), torch.device("cpu"),
                                  nodes=24)
        assert result["correct"], (w["name"], result["compared"])
        print(f"cell {w['name']}: the port on the CPU inside the limits "
              f"{result['compared']}")


def check_bare_directory() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "perfbench", Path(tmp) / "perfbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp)
        out = subprocess.run(
            [sys.executable, "-m", "perfbench.run", "--workload", "har-fleet",
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and not out.stdout.strip(), out.stdout
    print("bare directory: no result, exit code", out.returncode)


def main() -> int:
    check_contract(load_json(ROOT / "BENCHMARK.json"))
    check_imports()
    check_discovery()
    check_cells()
    check_bare_directory()
    print("selfcheck: all passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
