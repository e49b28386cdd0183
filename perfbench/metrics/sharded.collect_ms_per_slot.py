"""Host time of the node-sharded engine's own work on rank 0, spread over
the call's slots: self time of the ``fleet.tile`` (the rank's tile of the
global inputs and of the carried whole-fleet state) and ``fleet.collect``
(the counts' all-reduce, the gathers of the traces and the carry) spans
over the traced segment's ``fleet.slot`` spans, in ms: host time read
under the profiler, an upper bound of the untraced run's
(``perfbench/spans.py``)."""
from perfbench.spans import ms_per_slot


def read(run):
    return ms_per_slot(run, ("fleet.tile", "fleet.collect"), "fleet.slot")
