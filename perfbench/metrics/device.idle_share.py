"""Share of the traced segment in which no operation ran on the device:
the profiler's device intervals against the same segment's host-clock
length, in %."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
