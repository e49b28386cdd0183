"""Device operations (kernels, copies, sets) the fleet engine launches a
slot, counted in the traced segment."""


def read(run):
    if run.trace is None or run.sut.kind != "fleet":
        return None
    return run.trace["launches"] / (run.traced_steps * run.sut.slots_per_step)
