"""Host spans of the port's hot paths, on the profiler's clock, with
Chrome-trace (Perfetto) JSON export.

PyTorch counterpart of :mod:`repro.obs.trace`.  :func:`span` marks a block
of host code at a layer boundary (``fleet.slot``, ``host.batch``, ...).  A
span is live when :func:`enable` was called or while a ``torch.profiler``
records; otherwise it returns one shared null context, so an off span reads
no clock, enters no ``record_function`` and builds no event.

A live span appends ``{name, ts, dur, id, parent, tid, args}`` to the
in-memory buffer (:func:`events`): ``ts`` and ``dur`` in µs, ``ts`` after
:data:`BASE_NS` on the Unix clock, the convention of a profiler trace's
``ts`` and ``baseTimeNanoseconds``; ``parent`` the id of the enclosing live
span on the same thread (None at the top).  While a profiler records, the
span also enters ``record_function(name)``, so it sits in the profiler's
trace as a ``user_annotation`` beside the device's kernels.  A span never
reads a device value and never synchronises: it times the host's enqueue,
and the device's time comes from the profiler's trace.

:func:`self_times` gives each name's count and self time (duration less
its children's); :func:`export_chrome_trace` writes the buffer as
``{"traceEvents": [...]}`` (``ph: "X"`` complete events) for Perfetto and
``chrome://tracing``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import defaultdict

import torch.autograd.profiler as _profiler

__all__ = ["BASE_NS", "enable", "enabled", "clear", "span", "events",
           "self_times", "export_chrome_trace"]

_LOCK = threading.Lock()
_ENABLED = False
_EVENTS: list[dict] = []
_IDS = itertools.count(1)
_OPEN = threading.local()            # per thread: the ids of open spans
# _clock() + _TO_UNIX_NS is the Unix clock in ns (monotonic, set against
# the Unix clock once at import); BASE_NS the whole second before that
_clock = time.perf_counter_ns
BASE_NS = time.time_ns() // 10 ** 9 * 10 ** 9
_TO_UNIX_NS = time.time_ns() - _clock()


def enable(on: bool = True) -> None:
    """Switch span recording on or off for the process (a recording
    profiler turns spans on by itself)."""
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def clear() -> None:
    """Drop all recorded events."""
    with _LOCK:
        _EVENTS.clear()


class _Off:
    """The shared context of a span that is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "args", "annotation", "id", "parent", "t0")

    def __init__(self, name: str, args: dict | None, profiling: bool):
        self.name, self.args = name, args
        self.annotation = (_profiler.record_function(name) if profiling
                           else None)

    def __enter__(self):
        if self.annotation is not None:
            self.annotation.__enter__()
        stack = getattr(_OPEN, "ids", None)
        if stack is None:
            stack = _OPEN.ids = []
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _clock()
        _OPEN.ids.pop()
        ev = {"name": self.name,
              "ts": (self.t0 + _TO_UNIX_NS - BASE_NS) / 1e3,
              "dur": (t1 - self.t0) / 1e3, "id": self.id,
              "parent": self.parent, "tid": threading.get_ident(),
              "args": self.args or {}}
        with _LOCK:
            _EVENTS.append(ev)
        if self.annotation is not None:
            self.annotation.__exit__(exc_type, exc, tb)
        return False


def span(name: str, args: dict | None = None):
    """A context around a block of host code: live under :func:`enable` or
    a recording profiler, else the shared null context.  ``args``: host
    ints to keep with the event (never a device value)."""
    profiling = _profiler._is_profiler_enabled
    if not (_ENABLED or profiling):
        return _OFF
    return _Span(name, args, profiling)


def events() -> list[dict]:
    """A copy of the recorded events, in the order they closed."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def self_times(evs: list[dict]) -> dict:
    """``{name: (count, self µs)}`` over ``evs``: each span's duration less
    the union of its children's intervals, summed by name."""
    children = defaultdict(list)
    for e in evs:
        if e["parent"] is not None:
            children[e["parent"]].append((e["ts"], e["ts"] + e["dur"]))
    out = {}
    for e in evs:
        start, end = e["ts"], e["ts"] + e["dur"]
        covered, reach = 0.0, start
        for a, b in sorted(children.get(e["id"], ())):
            a, b = max(a, reach), min(b, end)
            if b > a:
                covered += b - a
                reach = b
        count, took = out.get(e["name"], (0, 0.0))
        out[e["name"]] = (count + 1, took + e["dur"] - covered)
    return out


def export_chrome_trace(path: str) -> int:
    """Write the recorded events as Chrome-trace JSON; returns how many."""
    pid = os.getpid()
    evs = [{"name": e["name"], "cat": "repro", "ph": "X", "ts": e["ts"],
            "dur": e["dur"], "pid": pid, "tid": e["tid"],
            "args": {**e["args"], "id": e["id"], "parent": e["parent"]}}
           for e in events()]
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": BASE_NS}, f)
    return len(evs)
