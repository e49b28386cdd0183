"""One run of one cell: set-up, the measured window, the traced segment,
the correctness check against the plain reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is found by its name: ``BENCHMARK.json`` names the cell's configuration and
traffic; ``workloads/<cell>.json`` the entry that drives the program, its
step and the limits of its compared numbers; ``configs/<config>.json`` the
sizes; ``mixes/<traffic>.json`` the traffic's parameters;
``entries/<entry>.py`` the code that drives it; ``metrics/<metric>.py`` the reader of
each metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell as its files describe it."""
    name: str
    bench: dict
    entry: dict          # BENCHMARK.json's workload entry
    spec: dict           # workloads/<cell>.json
    config: dict         # configs/<config>.json
    mix: dict            # mixes/<traffic>.json
    limits: dict         # the compared numbers' limits, from the spec

    def metrics(self, kind: str) -> list[dict]:
        """The cell's end-to-end (``end_to_end``) or per-layer
        (``per_layer``) metrics."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; "
                         f"options: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    spec = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(name=name, bench=bench, entry=entry, spec=spec,
                config=load_json(ROOT / configs[entry["config"]]["file"]),
                mix=load_json(HERE / "mixes" / f"{entry['traffic']}.json"),
                limits=spec["limits"])


@dataclasses.dataclass
class Context:
    """What an entry's set-up gets."""
    cell: Cell
    seed: int
    device: object
    nodes: int | None = None       # a smaller fleet, for the CPU self-checks

    @property
    def config(self):
        return self.cell.config

    @property
    def mix(self):
        return self.cell.mix

    @property
    def spec(self):
        return self.cell.spec


def setup_entry(ctx: Context):
    mod = load_module(HERE / "entries" / f"{ctx.spec['entry']}.py",
                      f"perfbench_entry_{ctx.spec['entry']}")
    return mod.setup(ctx)


def pack(parts: dict) -> tuple[list, object]:
    """Device tensors -> (their names, shapes and dtypes; one float64
    vector of them all on the host).  float64 holds every value the
    records keep exactly (float32, int32, 32-bit words, flags)."""
    import torch
    layout = [(k, v.shape, v.dtype) for k, v in parts.items()]
    flat = torch.cat([v.reshape(-1).to(torch.float64) for v in parts.values()])
    return layout, flat.cpu()


def unpack(flat, layout: list) -> dict:
    """The inverse of :func:`pack` on (..., F) rows of packed vectors."""
    out, at = {}, 0
    for name, shape, dtype in layout:
        n = shape.numel()
        out[name] = flat[..., at:at + n].reshape(
            flat.shape[:-1] + tuple(shape)).to(dtype)
        at += n
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    sut: object
    cell: Cell
    setup_s: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    window_steps: int = 0
    window_flops: float = 0.0
    peak_bytes: int = 0
    trace: dict | None = None
    traced_steps: int = 0
    syncs: int = 0
    sync_steps: int = 0


def read_metrics(run: Run, kind: str) -> dict:
    out = {}
    for m in run.cell.metrics(kind):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             f"perfbench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number against its limit (at most the limit passes)."""
    compared = {k: {"value": numbers[k], "limit": lim}
                for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok and bool(compared), compared


def measure(run: Run, seconds: float) -> None:
    """The window: steps until ``seconds`` have passed, each timed on the
    host clock from its call to its synchronisation."""
    sut = run.sut
    flops0 = sut.model_flops()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        sut.step()
        te = time.perf_counter()
        run.step_s.append(te - ts)
        if te - t0 >= seconds:
            break
    run.window_s = te - t0
    run.window_steps = len(run.step_s)
    run.window_flops = sut.model_flops() - flops0


def traced_segment(run: Run, steps: int, torch) -> None:
    """``steps`` more steps under ``torch.profiler``, each inside a span
    named after the layer the step calls into; the Chrome trace is reduced
    and deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.trace import reduce_trace
    sut = run.sut
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function(sut.layer_span()):
                sut.step()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        run.trace = reduce_trace(path, window)
    finally:
        os.unlink(path)
    run.traced_steps = steps


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            t_start: float, dev, nodes: int | None = None) -> tuple:
    """Set-up, window, traced segment and check of one run on ``dev``;
    returns the result line's object and every number the check read.  On
    a CPU (the self-checks) nothing is synchronised, traced or measured in
    device memory."""
    import torch

    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu", "count": cell.entry["chips"]}
    if cuda:
        device.update(kind=torch.cuda.get_device_name(0), power=power_limit())
        print(f"perfbench {cell.name} seed {seed}: {device['power']}, torch "
              f"{torch.__version__} cuda {torch.version.cuda}",
              file=sys.stderr)
    sut = setup_entry(Context(cell, seed, dev, nodes))
    for _ in range(cell.spec["warmup_steps"]):
        sut.step()
    if cuda:
        torch.cuda.synchronize()
    run = Run(sut=sut, cell=cell, setup_s=time.perf_counter() - t_start)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    measure(run, seconds)
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if trace:
        traced_segment(run, cell.spec["trace_steps"], torch)
        if cell.spec.get("sync_steps"):
            count_syncs(run, cell.spec["sync_steps"], torch)
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
    metrics = read_metrics(run, "per_layer" if trace else "end_to_end")
    if cuda:
        device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    sut.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = sut.check()
    correct, compared = judge(numbers, cell.limits)
    attempted = len(sut.kept) * sut.work_per_step
    # a run judged not correct counts all its work as failed
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else attempted,
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = {
            "device_ops": [list(x) for x in run.trace["device_ops"][:10]],
            "idle_gaps": [list(x) for x in run.trace["idle_gaps"][:10]]}
    info = {k: v for k, v in numbers.items() if k not in cell.limits}
    print(f"perfbench: {run.window_steps} steps in {run.window_s:.4f} s, "
          f"step ms median {statistics.median(run.step_s) * 1e3:.4f}, "
          f"set-up {run.setup_s:.4f} s; also read {info}", file=sys.stderr)
    for k, v in compared.items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result["compared"] = compared
    return result, numbers


def count_syncs(run: Run, steps: int, torch) -> None:
    """``steps`` more steps under CUDA's synchronisation debug mode: the
    synchronising operations they issue (the warnings cost only at the
    synchronisations)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                run.sut.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    run.syncs = sum("synchroniz" in str(w.message) for w in seen)
    run.sync_steps = steps


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float) -> int:
    """One run on the card; prints the result line and returns 0, or
    prints nothing on standard output and returns another code."""
    import torch

    cell = find_cell(name)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    result, _ = execute(cell, seed, seconds, trace, t_start,
                        torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded {found}, which the benchmark must not "
              f"load", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
