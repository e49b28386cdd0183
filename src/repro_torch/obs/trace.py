"""Wall-clock span tracer with Chrome-trace (Perfetto) JSON export.

PyTorch counterpart of :mod:`repro.obs.trace`.  :func:`span` records a
wall-clock span around a block; CUDA work is asynchronous, so a span can
``flush`` first: given tensors (any nested dict/tuple of them) or a
zero-argument callable returning them, it calls
``torch.cuda.synchronize()`` before the end timestamp when one of them lies
on a CUDA device, and the device work is inside the span.

Tracing is off by default, and then a span runs its body with no clock
read, no flush and no event.  :func:`export_chrome_trace` writes the
``{"traceEvents": [...]}`` format (``ph: "X"`` complete events in µs) that
Perfetto and ``chrome://tracing`` load.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

__all__ = ["enable", "enabled", "clear", "span", "instant", "events",
           "export_chrome_trace"]

_LOCK = threading.Lock()
_ENABLED = False
_EVENTS: list[dict] = []
_T0_NS = time.perf_counter_ns()


def enable(on: bool = True) -> None:
    """Switch span recording on or off for the process."""
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def clear() -> None:
    """Drop all recorded events."""
    with _LOCK:
        _EVENTS.clear()


def _now_us() -> float:
    return (time.perf_counter_ns() - _T0_NS) / 1e3


def _record(ev: dict) -> None:
    with _LOCK:
        _EVENTS.append(ev)


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_on_cuda(v) for v in tree)
    return False


@contextlib.contextmanager
def span(name: str, cat: str = "repro", args: dict | None = None,
         flush=None):
    """Record a wall-clock span around a block.  ``flush``: tensors or a
    callable returning them; the span waits for the card
    (``torch.cuda.synchronize``) before closing when one of them is on
    CUDA."""
    if not _ENABLED:
        yield
        return
    t0 = _now_us()
    try:
        yield
    finally:
        if flush is not None and _on_cuda(flush() if callable(flush)
                                          else flush):
            torch.cuda.synchronize()
        _record({"name": name, "cat": cat, "ph": "X", "ts": t0,
                 "dur": _now_us() - t0, "pid": os.getpid(),
                 "tid": threading.get_ident(),
                 **({"args": args} if args else {})})


def instant(name: str, cat: str = "repro", args: dict | None = None) -> None:
    """Record a zero-duration instant event."""
    if not _ENABLED:
        return
    _record({"name": name, "cat": cat, "ph": "i", "s": "p",
             "ts": _now_us(), "pid": os.getpid(),
             "tid": threading.get_ident(),
             **({"args": args} if args else {})})


def events() -> list[dict]:
    """A copy of the recorded events."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def export_chrome_trace(path: str) -> int:
    """Write the recorded events as Chrome-trace JSON; returns how many."""
    evs = events()
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return len(evs)
