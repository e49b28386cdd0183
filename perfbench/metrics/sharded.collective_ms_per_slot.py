"""Device time of the NCCL kernels on rank 0's card a slot, in ms, over
the traced segment (every rank traced alike): the collectives' transfers
plus the wait inside them for the slowest rank."""
from perfbench.trace import kernel_seconds


def read(run):
    if run.trace is None:
        return None
    took = kernel_seconds(run.trace, "nccl")
    if took <= 0:
        return None
    return took * 1e3 / (run.traced_steps * run.sut.slots_per_step)
