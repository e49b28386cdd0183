"""Host time of the fleet engine's host recovery and host CNN a slot: self
time of the ``fleet.host`` spans (``_host_logits``, one per node block)
over the traced segment's ``fleet.slot`` spans, in ms: host time read under
the profiler, which slows the host about 2x, so an upper bound of the
untraced run's (``perfbench/spans.py``)."""
from perfbench.spans import ms_per_slot


def read(run):
    return ms_per_slot(run, ("fleet.host",), "fleet.slot")
