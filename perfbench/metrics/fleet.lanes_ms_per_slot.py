"""Host time of the fleet engine's carry, lanes and loop glue a slot: self
time of the ``fleet.carry`` spans (block joins, keep and freeze, brown-out,
the emitted traces, telemetry) and of the ``fleet.slot`` spans themselves
(the block slicing between the other spans) over the traced segment's
``fleet.slot`` spans, in ms: host time read under the profiler, which slows
the host about 2x, so an upper bound of the untraced run's
(``perfbench/spans.py``)."""
from perfbench.spans import ms_per_slot


def read(run):
    return ms_per_slot(run, ("fleet.carry", "fleet.slot"), "fleet.slot")
