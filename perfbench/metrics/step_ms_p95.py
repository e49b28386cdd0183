"""The 95th percentile of the window's step times (host clock, each step
from its call to its synchronisation), in ms."""
import statistics


def read(run):
    return statistics.quantiles(run.step_s, n=100,
                                method="inclusive")[94] * 1e3
