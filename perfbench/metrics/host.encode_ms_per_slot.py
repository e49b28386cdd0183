"""Host time of the host tier's edge encode and wire a slot: self time of the
``host.serve_step`` spans (the step's checks and glue) and the
``host.encode`` spans (the coreset encode, the alive and wire-byte count)
over the traced segment's ``host.serve_step`` spans, in ms: host time read
under the profiler, which slows the host about 2x, so an upper bound of the
untraced run's (``perfbench/spans.py``)."""
from perfbench.spans import ms_per_slot


def read(run):
    return ms_per_slot(run, ("host.serve_step", "host.encode"),
                       "host.serve_step")
