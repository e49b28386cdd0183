"""Device operations (kernels, copies, sets) the host tier's serve slot
launches, counted in the traced segment: the edge encode, the queue push,
the microbatches' cache, recovery and host CNN, the telemetry lanes."""


def read(run):
    if run.trace is None or run.sut.kind != "host":
        return None
    return run.trace["launches"] / (run.traced_steps * run.sut.slots_per_step)
