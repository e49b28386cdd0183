"""Earliest-deadline-first microbatch assembly for the host DNN.

PyTorch counterpart of :mod:`repro.host.scheduler`.  Each pop takes the
``batch_size`` live entries with the earliest deadlines (a stable sort:
ties go to the lowest slot) as one fixed-shape batch, padding rows with
``valid=False``; entries whose deadline has passed are expired first and
counted as deadline misses.  A deadline is inclusive: an entry popped at
``now == deadline`` is on time.  Nothing here reads a tensor on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .queue import NO_DEADLINE, PayloadQueue, tree_map

__all__ = ["MicroBatch", "batch_task_counts", "batch_wait_slots",
           "expire_deadlines", "edf_pop_batch"]


class MicroBatch(NamedTuple):
    """A fixed-shape batch of queue entries (leading axis ``batch_size``).
    Padding rows (the queue held fewer live entries) have ``valid=False``."""

    payload: Any                # NamedTuple of (B, ...) rows
    node_id: torch.Tensor       # (B,) int32
    arrival: torch.Tensor       # (B,) int32
    deadline: torch.Tensor      # (B,) int32
    valid: torch.Tensor         # (B,) bool


def expire_deadlines(q: PayloadQueue, now
                     ) -> tuple[PayloadQueue, torch.Tensor]:
    """Invalidate entries whose deadline has passed (``deadline < now``);
    returns ``(queue, n_missed)``, the deadline-miss accounting."""
    missed = q.valid & (q.deadline < now)
    return q._replace(valid=q.valid & ~missed), \
        missed.sum().to(torch.int32)


def edf_pop_batch(q: PayloadQueue, batch_size: int, now=None
                  ) -> tuple[PayloadQueue, MicroBatch, torch.Tensor]:
    """Pop the ``batch_size`` earliest-deadline live entries as one
    :class:`MicroBatch`.  With ``now`` given, late entries are expired (and
    counted) first.  Returns ``(queue, batch, n_missed)``."""
    missed = torch.zeros((), dtype=torch.int32, device=q.valid.device)
    if now is not None:
        q, missed = expire_deadlines(q, now)
    keys = torch.where(q.valid, q.deadline, NO_DEADLINE)
    take = torch.argsort(keys, stable=True)[:batch_size]
    batch = MicroBatch(
        payload=tree_map(lambda a: a[take], q.payload),
        node_id=q.node_id[take], arrival=q.arrival[take],
        deadline=q.deadline[take], valid=q.valid[take])
    return q._replace(valid=q.valid.index_fill(0, take, False)), batch, \
        missed


def batch_task_counts(batch: MicroBatch, n_tasks: int) -> torch.Tensor:
    """(n_tasks,) int32: how many valid rows of this microbatch belong to
    each workload.  Payloads without a ``task`` leaf count as task 0."""
    task = getattr(batch.payload, "task", None)
    if task is None:
        task = torch.zeros(batch.valid.shape, dtype=torch.int32,
                           device=batch.valid.device)
    tid = torch.clamp(task.to(torch.int64), 0, n_tasks - 1)
    return torch.zeros((n_tasks,), dtype=torch.int32,
                       device=tid.device).index_add_(
        0, tid, batch.valid.to(torch.int32))


def batch_wait_slots(batch: MicroBatch, now) -> torch.Tensor:
    """(B,) int32 queue sojourn of each row at service time ``now`` (0 on
    padding rows): the observable QoS percentiles are taken from."""
    return torch.where(batch.valid, now - batch.arrival, 0).to(torch.int32)
