"""Host time of the fleet engine's per-call overhead, spread over the call's
slots: self time of the ``fleet.step``, ``fleet.prepare`` (checks, device
moves, noise source, carry, weight quantisation) and ``fleet.aggregates``
(stacks, argmax, aggregates, the result) spans over the traced segment's
``fleet.slot`` spans, in ms: host time read under the profiler, which slows
the host about 2x, so an upper bound of the untraced run's
(``perfbench/spans.py``)."""
from perfbench.spans import ms_per_slot


def read(run):
    return ms_per_slot(run, ("fleet.step", "fleet.prepare",
                             "fleet.aggregates"), "fleet.slot")
