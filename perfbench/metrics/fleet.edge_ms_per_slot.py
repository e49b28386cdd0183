"""Host time of the fleet engine's node side a slot: self time of the spans
``fleet.noise`` (the slot's noise draw and window expand), ``fleet.corr``
(the signature correlation), ``fleet.sensor`` (the sensor ladder) and
``fleet.intermittent`` (the lane, when on) over the traced segment's
``fleet.slot`` spans, in ms: host time read under the profiler, which slows
the host about 2x, so an upper bound of the untraced run's
(``perfbench/spans.py``)."""
from perfbench.spans import ms_per_slot


def read(run):
    return ms_per_slot(run, ("fleet.noise", "fleet.corr", "fleet.sensor",
                             "fleet.intermittent"), "fleet.slot")
