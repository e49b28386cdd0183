"""Synchronising operations a serve slot issues, counted under CUDA's
synchronisation debug mode over a few steps after the traced segment."""


def read(run):
    if not run.sync_steps or run.sut.kind != "host":
        return None
    return run.syncs / (run.sync_steps * run.sut.slots_per_step)
