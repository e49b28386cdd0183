"""The program's own spans (``repro_torch.obs.trace``) in the traced
segment, for the per-layer metrics that read them.

In a ``--trace 1`` run the span buffer holds exactly the traced segment's
steps: the spans record only while the profiler does (nothing calls
``enable()``).  The times are host times read under the profiler, which
slows the host about 2x: upper bounds of the untraced run's, as
``device.idle_share``'s is."""
from __future__ import annotations


def ms_per_slot(run, names: tuple, slot_span: str) -> float | None:
    """Self time of the spans ``names`` (summed by name), in ms, per
    ``slot_span`` span the program recorded; None in an untraced run, or
    where the program records none of them (one without these spans, or a
    cell that does not run them)."""
    if run.trace is None:
        return None
    try:
        from repro_torch.obs import trace
        self_times = trace.self_times
    except (ImportError, AttributeError):
        return None
    times = self_times(trace.events())
    slots = times.get(slot_span, (0, 0.0))[0]
    found = [times[n][1] for n in names if n in times]
    if not slots or not found:
        return None
    return sum(found) / slots / 1e3
