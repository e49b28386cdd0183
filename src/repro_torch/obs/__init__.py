"""Fleet observability: the metrics registry and the span tracer.

* :mod:`repro_torch.obs.registry`: counter, gauge and histogram lanes
  declared once and held as int32 tensors, exact and merge-able across
  segments;
* :mod:`repro_torch.obs.trace`: host spans at the hot paths' layer
  boundaries, live under ``enable()`` or a recording profiler (then also
  its annotations), exported as Chrome-trace JSON;
* :mod:`repro_torch.obs.compile_guard`: builds per distinct shape counted,
  with a budget that raises.
"""
from . import trace  # noqa: F401
from .compile_guard import (  # noqa: F401
    CompileBudgetError, compile_count, compile_counts, compile_event,
    compile_guard, compile_key_counts, reset_compile_counts,
)
from .registry import (  # noqa: F401
    Lane, MetricsSpec, categorical_counts, counter, counter_add,
    counter_value, counters_add, gauge, gauge_set, hist_observe, histogram,
    int_pair_sum, int_pair_total, lane_edges, metrics_init, metrics_merge,
    metrics_psum, metrics_summary, percentile_from_hist, spec_union,
)
