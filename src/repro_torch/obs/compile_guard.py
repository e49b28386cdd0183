"""Compile-count accounting: builds per distinct shape as a tracked metric.

PyTorch counterpart of :mod:`repro.obs.compile_guard`, the same pure-Python
counter.  The JAX package counts one event per traced (compiled) shape.
PyTorch runs eagerly and compiles nothing, so the port counts what it
builds per shape instead: the host server calls :func:`compile_event` the
first time it builds the per-configuration constants of a serve shape
(:func:`repro_torch.host.server.serve_trace_count`).

* :func:`compile_event` counts one build of ``component`` (with an optional
  hashable ``key``: a config dataclass, a shape tuple);
* :func:`compile_count` reads per-component totals, and
  :func:`compile_guard` wraps a block and RAISES
  :class:`CompileBudgetError` when the block built more shapes than its
  budget.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Hashable

__all__ = ["compile_event", "compile_count", "compile_counts",
           "compile_key_counts", "reset_compile_counts", "compile_guard",
           "CompileBudgetError"]

_COUNTS: collections.Counter = collections.Counter()


class CompileBudgetError(RuntimeError):
    """A block compiled more distinct shapes than its declared budget."""


def compile_event(component: str, key: Hashable = None) -> None:
    """Count one build of ``component`` for a new shape (never per
    step)."""
    _COUNTS[(component, key)] += 1


def compile_count(component: str | None = None,
                  key: Hashable = None) -> int:
    """Build events so far: for one ``(component, key)``, for every key of
    a ``component``, or the global total."""
    if component is None:
        return sum(_COUNTS.values())
    if key is not None:
        return _COUNTS[(component, key)]
    return sum(n for (c, _), n in _COUNTS.items() if c == component)


def compile_key_counts(component: str) -> dict:
    """``{key: build events}`` for one component: lets a caller group keys
    its own way (the host probe's ``batches_per_slot``-normalized
    per-config accounting)."""
    return {k: n for (c, k), n in _COUNTS.items() if c == component}


def compile_counts() -> dict[str, int]:
    """Per-component totals."""
    out: dict[str, int] = {}
    for (c, _), n in _COUNTS.items():
        out[c] = out.get(c, 0) + n
    return dict(sorted(out.items()))


def reset_compile_counts() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def compile_guard(component: str, budget: int):
    """Assert the wrapped block stays within its compiled-shape budget.

    ``with compile_guard("host.serve", 2): ...`` raises
    :class:`CompileBudgetError` if more than ``budget`` new build events for
    ``component`` occur inside the block.
    """
    before = compile_count(component)
    yield
    grew = compile_count(component) - before
    if grew > budget:
        raise CompileBudgetError(
            f"{component} compiled {grew} distinct shapes inside a "
            f"compile_guard budget of {budget} — a shape that varies per "
            f"call is defeating the compile cache")
