"""Host time of the host tier's queue and EDF a slot: self time of the
``host.ingest`` (entries, slot constants, the queue push) and ``host.pop``
(the EDF microbatch pops) spans over the traced segment's
``host.serve_step`` spans, in ms: host time read under the profiler, which
slows the host about 2x, so an upper bound of the untraced run's
(``perfbench/spans.py``)."""
from perfbench.spans import ms_per_slot


def read(run):
    return ms_per_slot(run, ("host.ingest", "host.pop"), "host.serve_step")
