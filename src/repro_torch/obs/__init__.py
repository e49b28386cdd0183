"""Fleet observability: the metrics registry and the span tracer.

* :mod:`repro_torch.obs.registry`: counter, gauge and histogram lanes
  declared once and held as int32 tensors, exact and merge-able across
  segments;
* :mod:`repro_torch.obs.trace`: wall-clock spans that wait for the card
  before closing, exported as Chrome-trace JSON.
"""
from . import trace  # noqa: F401
from .registry import (  # noqa: F401
    Lane, MetricsSpec, categorical_counts, counter, counter_add,
    counter_value, counters_add, gauge, gauge_set, hist_observe, histogram,
    int_pair_sum, int_pair_total, lane_edges, metrics_init, metrics_merge,
    metrics_summary, percentile_from_hist, spec_union,
)
