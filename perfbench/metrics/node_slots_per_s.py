"""Simulated node-slots completed a second: the fleet size times the slots
of every step of the window, over the window's seconds (host clock)."""


def read(run):
    return run.window_steps * run.sut.work_per_step / run.window_s
