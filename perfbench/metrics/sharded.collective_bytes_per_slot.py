"""Bytes rank 0 put into the program's collectives a slot over the
window (``repro_torch.sharding.collective_counts()``, counted on the host
at issue from the shapes): its tile of every gather and the counts it
all-reduces."""


def read(run):
    per_slot = getattr(run.sut, "collective_bytes_per_slot", None)
    if per_slot is None:
        return None
    return per_slot(run.cell.spec["warmup_steps"], run.window_steps)
