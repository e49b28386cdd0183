"""Metrics registry: telemetry lanes declared once, held as int32 tensors.

PyTorch counterpart of :mod:`repro.obs.registry`.  A :class:`MetricsSpec`
declares named lanes once (counter, gauge or fixed-bin histogram);
:func:`metrics_init` makes the flat ``{name: int32 tensor}`` dict a run
carries from slot to slot, and every update op is a fixed-shape tensor op:

* counters are (2,) int32 ``[hi, lo]`` base-2**16 digit pairs, kept
  normalized (``lo < 2**16``), so a total is exact and its pair unique;
* gauges are () int32 levels, histograms (bins,) int32 counts over static
  edges (log-spaced, or categorical integer bins).

Integer adds are associative, so a lane's value does not depend on how a
run was split into segments (:func:`metrics_merge`).  ``torch.sum`` of an
int32 tensor returns int64; every sum here is cast back to int32, so the
pairs have the JAX layout and wrap the same way.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["Lane", "MetricsSpec", "counter", "gauge", "histogram",
           "metrics_init", "counter_add", "counters_add", "gauge_set",
           "hist_observe", "metrics_psum", "metrics_merge", "counter_value",
           "int_pair_total", "int_pair_sum", "categorical_counts",
           "lane_edges", "percentile_from_hist", "metrics_summary",
           "spec_union"]

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# digit base of the int32 pairs: digit sums stay exact in int32 for up to
# 32767 terms of < 2**31 each
_DIGIT = 16
_MASK = (1 << _DIGIT) - 1


@dataclasses.dataclass(frozen=True)
class Lane:
    """One declared metric lane.  ``kind``: ``"counter"`` (exact int total
    as a normalized ``[hi, lo]`` pair), ``"gauge"`` (an int32 level re-set
    each slot, latest wins across segments) or ``"histogram"`` ((bins,)
    int32 counts over log-spaced edges on ``(lo, hi)`` when ``log``, else
    categorical bins ``0..bins-1``; the last bin catches overflow)."""

    name: str
    kind: str
    unit: str = ""
    bins: int = 0
    lo: float = 1.0
    hi: float = 1024.0
    log: bool = True

    def __post_init__(self):
        if self.kind not in (COUNTER, GAUGE, HISTOGRAM):
            raise ValueError(f"unknown lane kind {self.kind!r}")
        if self.kind == HISTOGRAM:
            if self.bins < 2:
                raise ValueError(
                    f"histogram lane {self.name!r} needs >= 2 bins")
            if self.log and not 0 < self.lo < self.hi:
                raise ValueError(
                    f"histogram lane {self.name!r} needs 0 < lo < hi for "
                    f"log-spaced edges, got ({self.lo}, {self.hi})")


def counter(name: str, unit: str = "") -> Lane:
    return Lane(name, COUNTER, unit)


def gauge(name: str, unit: str = "") -> Lane:
    return Lane(name, GAUGE, unit)


def histogram(name: str, bins: int, lo: float = 1.0, hi: float = 1024.0,
              unit: str = "", log: bool = True) -> Lane:
    return Lane(name, HISTOGRAM, unit, bins=bins, lo=lo, hi=hi, log=log)


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """The declared lane set (frozen and hashable)."""

    lanes: tuple[Lane, ...]

    def __post_init__(self):
        names = [ln.name for ln in self.lanes]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate lane names: {sorted(dupes)}")

    def lane(self, name: str) -> Lane:
        for ln in self.lanes:
            if ln.name == name:
                return ln
        raise KeyError(f"no lane {name!r} declared; spec has "
                       f"{[ln.name for ln in self.lanes]}")

    def names(self) -> tuple[str, ...]:
        return tuple(ln.name for ln in self.lanes)


def spec_union(*lane_groups) -> MetricsSpec:
    """One :class:`MetricsSpec` from lane groups (tuples of :class:`Lane`
    or whole specs), in order; a name claimed twice fails the spec's own
    check."""
    lanes: list[Lane] = []
    for group in lane_groups:
        lanes.extend(group.lanes if isinstance(group, MetricsSpec) else group)
    return MetricsSpec(tuple(lanes))


@functools.lru_cache(maxsize=256)
def lane_edges(lane: Lane) -> tuple[float, ...]:
    """The ``bins - 1`` static edges of a histogram lane: a value lands in
    bin ``sum(v > edges)``."""
    if lane.kind != HISTOGRAM:
        raise ValueError(f"{lane.name!r} is not a histogram lane")
    if lane.log:
        return tuple(float(e) for e in
                     np.geomspace(lane.lo, lane.hi, lane.bins - 1))
    return tuple(float(k) + 0.5 for k in range(lane.bins - 1))


# never evicted: a captured serve or fleet graph (host/server.py,
# serving/fleet.py) reads it
@functools.lru_cache(maxsize=None)
def _edges_tensor(lane: Lane, device: torch.device) -> torch.Tensor:
    """:func:`lane_edges` as float32 on ``device``, made once: a slot's
    histogram update then copies nothing from the host."""
    return torch.tensor(lane_edges(lane), dtype=torch.float32, device=device)


def metrics_init(spec: MetricsSpec, device=None) -> dict:
    """The zeroed metrics dict: counters (2,), gauges (), histograms
    (bins,), all int32."""
    shapes = {COUNTER: (2,), GAUGE: ()}
    return {ln.name: torch.zeros(shapes.get(ln.kind, (ln.bins,)),
                                 dtype=torch.int32, device=device)
            for ln in spec.lanes}


def _norm_pair(pair: torch.Tensor) -> torch.Tensor:
    """Canonical ``[hi, lo]`` (also on a (K, 2) stack of pairs): lo's
    overflow digits carried into hi."""
    hi, lo = pair[..., 0], pair[..., 1]
    return torch.stack([hi + (lo >> _DIGIT), lo & _MASK], dim=-1)


def _as_int32(values, mask=None) -> torch.Tensor:
    """Counter input as int32: bool counts 0/1, floats round half to even
    (``torch.round``, as ``jnp.round``); masked-out entries are 0."""
    v = torch.as_tensor(values)
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    elif v.is_floating_point():
        v = torch.round(v).to(torch.int32)
    else:
        v = v.to(torch.int32)
    if mask is not None:
        v = torch.where(torch.as_tensor(mask, device=v.device), v, 0)
    return v


def _digit_sums(v: torch.Tensor, dim=None) -> torch.Tensor:
    """``[sum(v >> 16), sum(v & 0xFFFF)]`` as int32, over ``dim`` (all
    elements when None), stacked on the last axis."""
    if dim is None:
        hi, lo = torch.sum(v >> _DIGIT), torch.sum(v & _MASK)
    else:
        hi, lo = torch.sum(v >> _DIGIT, dim=dim), torch.sum(v & _MASK,
                                                           dim=dim)
    return torch.stack([hi, lo], dim=-1).to(torch.int32)


def int_pair_sum(values, mask=None) -> torch.Tensor:
    """Exact masked sum of non-negative values as an unnormalized (2,)
    int32 ``[hi, lo]`` pair: each value is split into base-2**16 digits
    before the reduction."""
    return _digit_sums(_as_int32(values, mask))


def int_pair_total(pair) -> int:
    """The exact Python int a (2,) ``[hi, lo]`` pair stands for."""
    if isinstance(pair, torch.Tensor):
        pair = pair.cpu()
    hi, lo = (int(x) for x in np.asarray(pair))
    return (hi << _DIGIT) + lo


def _check_kind(spec: MetricsSpec, name: str, kind: str) -> Lane:
    ln = spec.lane(name)
    if ln.kind != kind:
        raise ValueError(f"{name!r} is not a {kind} lane")
    return ln


def counter_add(spec: MetricsSpec, metrics: dict, name: str, values,
                mask=None) -> dict:
    """Add a masked batch of non-negative values to a counter lane, exactly;
    the pair stays normalized."""
    _check_kind(spec, name, COUNTER)
    pair = metrics[name] + int_pair_sum(values, mask)
    return {**metrics, name: _norm_pair(pair)}


def counters_add(spec: MetricsSpec, metrics: dict, updates) -> dict:
    """:func:`counter_add` for several counter lanes at once: ``updates`` is
    a sequence of ``(name, values, mask)`` whose values share one shape.
    The masked values are stacked into one (K, ...) int32 tensor, split into
    digits once and summed once: bit for bit the lane-by-lane fold (each
    lane's pair is the same integer sums), in a fixed number of launches."""
    if not updates:
        return metrics
    names = [u[0] for u in updates]
    for name in names:
        _check_kind(spec, name, COUNTER)
    if len(set(names)) != len(names):
        raise ValueError(f"counters_add got a lane twice: {names}")
    v = torch.stack([_as_int32(values, mask) for _, values, mask in updates])
    sums = _digit_sums(v.reshape(len(names), -1), dim=1)        # (K, 2)
    pairs = _norm_pair(torch.stack([metrics[n] for n in names]) + sums)
    return {**metrics, **dict(zip(names, pairs.unbind(0)))}


def gauge_set(spec: MetricsSpec, metrics: dict, name: str, value) -> dict:
    """Overwrite a gauge lane with this slot's level (() int32)."""
    _check_kind(spec, name, GAUGE)
    return {**metrics, name: torch.as_tensor(value).to(torch.int32)}


def hist_observe(spec: MetricsSpec, metrics: dict, name: str, values,
                 mask=None) -> dict:
    """Record a masked batch of values into a histogram lane: bin
    ``sum(v > edges)``, compared in float32 against the float32 edges, and
    int32 scatter-adds."""
    ln = _check_kind(spec, name, HISTOGRAM)
    v = torch.as_tensor(values).to(torch.float32).reshape(-1)
    edges = _edges_tensor(ln, v.device)
    idx = torch.sum(v[:, None] > edges[None, :], dim=-1)
    m = (torch.ones(v.shape, dtype=torch.int32, device=v.device)
         if mask is None else torch.as_tensor(mask).reshape(-1)
         .to(torch.int32))
    counts = torch.zeros((ln.bins,), dtype=torch.int32,
                         device=v.device).index_add_(0, idx, m)
    return {**metrics, name: metrics[name] + counts}


def categorical_counts(values, bins: int, mask=None) -> torch.Tensor:
    """(bins,) int32 masked counts of integer codes; a code outside
    ``[0, bins)`` counts nowhere (``jax.nn.one_hot`` of it is zeros)."""
    v = torch.as_tensor(values).reshape(-1).long()
    keep = (v >= 0) & (v < bins)
    if mask is not None:
        keep = keep & torch.as_tensor(mask).reshape(-1).to(torch.bool)
    return torch.zeros((bins,), dtype=torch.int32, device=v.device
                       ).index_add_(0, v.clamp(0, bins - 1),
                                    keep.to(torch.int32))


def metrics_psum(spec: MetricsSpec, metrics: dict, group=None) -> dict:
    """Every lane summed over the ranks of ``group`` (a
    ``torch.distributed`` process group; ``None`` is the default group),
    counters re-normalized afterwards.  Each rank's pairs are canonical, so
    their digit sums stay exact in int32 for any realistic rank count.  The
    lanes travel as one flat int32 tensor, one all-reduce."""
    import torch.distributed as dist

    from ..sharding import _count
    flat = torch.cat([metrics[ln.name].reshape(-1) for ln in spec.lanes])
    _count("all_reduce", flat)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = {}, 0
    for ln in spec.lanes:
        size = metrics[ln.name].numel()
        summed = flat[at:at + size].reshape(metrics[ln.name].shape)
        at += size
        out[ln.name] = _norm_pair(summed) if ln.kind == COUNTER else summed
    return out


def metrics_merge(spec: MetricsSpec, a: dict | None, b: dict) -> dict:
    """Combine two lane dicts: counters add exactly (re-normalized),
    histograms add, gauges take ``b``'s level (the later segment)."""
    if a is None:
        return b
    out = {}
    for ln in spec.lanes:
        if ln.kind == COUNTER:
            out[ln.name] = _norm_pair(a[ln.name] + b[ln.name])
        elif ln.kind == GAUGE:
            out[ln.name] = b[ln.name]
        else:
            out[ln.name] = a[ln.name] + b[ln.name]
    return out


def counter_value(metrics: dict, name: str) -> int:
    """The exact value of a counter lane, as a Python int."""
    return int_pair_total(metrics[name])


def percentile_from_hist(counts, edges, q: float) -> float:
    """Percentile ``q`` (0..100) from fixed-bin counts, interpolated inside
    the bin where the cumulative count crosses it (bin 0 spans
    ``[0, edges[0]]``; the overflow bin reports its lower edge); ``nan`` on
    an empty histogram."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu()
    counts = np.asarray(counts, dtype=np.int64)
    edges = np.asarray(edges, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return float("nan")
    target = max(q / 100.0 * total, 1e-12)
    cum = np.cumsum(counts)
    idx = int(np.searchsorted(cum, target, side="left"))
    if idx >= len(edges):                       # overflow bin
        return float(edges[-1])
    lo = 0.0 if idx == 0 else float(edges[idx - 1])
    hi = float(edges[idx])
    inside = target - (0 if idx == 0 else cum[idx - 1])
    frac = inside / max(counts[idx], 1)
    return lo + (hi - lo) * min(frac, 1.0)


def metrics_summary(spec: MetricsSpec, metrics: dict) -> dict:
    """Host-side JSON view: counters and gauges as ints, histograms as
    ``{counts, edges, unit, p50, p95, p99}``."""
    out = {}
    for ln in spec.lanes:
        if ln.kind == COUNTER:
            out[ln.name] = counter_value(metrics, ln.name)
        elif ln.kind == GAUGE:
            out[ln.name] = int(metrics[ln.name])
        else:
            counts = metrics[ln.name].cpu().tolist()
            edges = list(lane_edges(ln))
            out[ln.name] = {
                "counts": counts, "edges": edges, "unit": ln.unit,
                **{f"p{q}": percentile_from_hist(counts, edges, float(q))
                   for q in (50, 95, 99)}}
    return out
