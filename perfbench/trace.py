"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics
read: every device operation with its time, the device's busy time over
the traced window, and the idle gaps by what the host was doing."""
from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost_at(cpu_ops: list, times: list) -> list:
    """Name of the innermost host op open at each of ``times`` (sorted), or
    None: one sweep over the ops of one thread, which nest."""
    bounds = []
    for name, ts, dur in cpu_ops:
        bounds.append((ts, 1, name))
        bounds.append((ts + dur, 0, name))
    bounds.sort(key=lambda b: (b[0], b[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(bounds) and bounds[i][0] <= t:
            _, opening, name = bounds[i]
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            i += 1
        out.append(stack[-1] if stack else None)
    return out


def reduce_trace(path, window_s: float) -> dict:
    """``device_ops`` [(name, seconds)] by total time, ``launches`` (device
    operations), ``busy_s`` (union of their intervals), ``window_s``, and
    ``idle_gaps`` [(host op, seconds)]: the time between device
    operations, summed by the innermost host op open at the middle of each
    gap (``host`` where none was)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, cpu_by_thread = [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat in ("cpu_op", "user_annotation"):
            cpu_by_thread[e.get("tid")].append(
                (e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
    dev.sort(key=lambda d: d[1])
    by_name = defaultdict(float)
    busy_us, end = 0.0, None
    gaps = []
    for name, ts, dur in dev:
        by_name[name] += dur
        if end is None or ts >= end:
            if end is not None and ts > end:
                gaps.append((end, ts))
            busy_us += dur
            end = ts + dur
        elif ts + dur > end:
            busy_us += ts + dur - end
            end = ts + dur
    # the host thread that launched most: the Python thread driving the step
    thread = max(cpu_by_thread, key=lambda k: len(cpu_by_thread[k]),
                 default=None)
    mids = [(a + b) / 2 for a, b in gaps]
    names = (_innermost_at(cpu_by_thread[thread], mids) if thread is not None
             else [None] * len(mids))
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, names):
        idle[name or "host"] += (b - a) * 1e-6
    return {
        "device_ops": sorted(((n, s * 1e-6) for n, s in by_name.items()),
                             key=lambda x: -x[1]),
        "launches": len(dev),
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "idle_gaps": sorted(idle.items(), key=lambda x: -x[1]),
    }


def kernel_seconds(trace: dict, match: str) -> float:
    """Device seconds of the operations whose name contains ``match``."""
    return sum(s for n, s in trace["device_ops"] if match in n)
