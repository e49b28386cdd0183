"""Fixed-capacity payload queue for the host tier.

PyTorch counterpart of :mod:`repro.host.queue`: a ring buffer of stamped
wire payloads (arrival slot, inclusive QoS deadline), with latest-deadline
overflow drops.  Every leaf keeps the reference's layout: a leading
``capacity`` axis, int32 bookkeeping, a bool ``valid`` lane.  Operations
return new tensors and leave their input queue as it was.

Pushing a batch has three paths, each with the sequential walk's queue,
cursor and drop count:

* no overflow (every masked entry fits the free slots): one vectorized
  scatter, the reference's bulk path;
* a lane whose entries share one deadline (what a serve slot pushes:
  arrival + ``qos_slots`` for every row): the fill phase and the eviction
  phase are both closed-form, one vectorized scatter and no host
  synchronisation (:func:`push_lane`);
* any other overflow: the sequential per-entry walk, a Python loop.

:func:`queue_push_batch` picks between the first and the last with one
host synchronisation on a CUDA tensor (the reference's ``lax.cond``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..graph_io import tree_map

__all__ = ["PayloadQueue", "queue_init", "queue_push", "queue_push_batch",
           "queue_occupancy", "queue_wait_slots", "NO_DEADLINE",
           "push_lane", "tree_map"]

# deadline key for empty slots: sorts after every real deadline
NO_DEADLINE = 2 ** 31 - 1


class PayloadQueue(NamedTuple):
    """Slot-array queue; every leaf has a leading ``capacity`` axis."""

    payload: Any                 # NamedTuple of (cap, ...) tensors
    node_id: torch.Tensor        # (cap,) int32 — originating fleet node
    arrival: torch.Tensor        # (cap,) int32 — slot the payload arrived
    deadline: torch.Tensor       # (cap,) int32 — QoS deadline (inclusive)
    valid: torch.Tensor          # (cap,) bool
    cursor: torch.Tensor         # () int32 — ring write cursor
    drops_overflow: torch.Tensor  # () int32 — payloads discarded by overflow


def queue_init(example_payload: Any, capacity: int) -> PayloadQueue:
    """Empty queue whose payload slots mirror ``example_payload`` (one
    unbatched entry; each leaf gains a leading capacity axis), on the
    device of its leaves."""
    devices = []

    def slots(a):
        devices.append(a.device)
        return torch.zeros((capacity,) + tuple(a.shape), dtype=a.dtype,
                           device=a.device)

    payload = tree_map(slots, example_payload)
    dev = devices[0]

    def z(dtype=torch.int32):
        return torch.zeros((capacity,), dtype=dtype, device=dev)

    return PayloadQueue(
        payload=payload, node_id=z(), arrival=z(),
        deadline=torch.full((capacity,), NO_DEADLINE, dtype=torch.int32,
                            device=dev),
        valid=z(torch.bool),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        drops_overflow=torch.zeros((), dtype=torch.int32, device=dev))


def queue_occupancy(q: PayloadQueue) -> torch.Tensor:
    """() int32 — number of live entries."""
    return q.valid.sum().to(torch.int32)


def queue_wait_slots(q: PayloadQueue, now) -> torch.Tensor:
    """(cap,) int32 — how long each entry has waited at slot ``now`` (0
    where ``q.valid`` is False): the backlog-age observable."""
    return torch.where(q.valid, now - q.arrival, 0).to(torch.int32)


def _ring_order(q: PayloadQueue) -> torch.Tensor:
    cap = q.valid.shape[0]
    return (torch.arange(cap, device=q.valid.device) - q.cursor) % cap


def _clone(q: PayloadQueue) -> PayloadQueue:
    return tree_map(torch.clone, q)


def _push_inplace(q: PayloadQueue, payload: Any, node_id, arrival, deadline,
                  mask) -> tuple[PayloadQueue, torch.Tensor]:
    """One sequential push, writing into ``q``'s buffers (the caller owns
    them); returns the queue with its new cursor and drop count, and
    whether an entry was dropped."""
    cap = q.valid.shape[0]
    dev = q.valid.device
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    deadline = torch.as_tensor(deadline, dtype=torch.int32, device=dev)
    # (1,) index tensors throughout: a 0-d tensor index would be read on
    # the host
    free_order = torch.where(q.valid, cap, _ring_order(q))
    free_slot = torch.argmin(free_order).reshape(1)
    has_free = (~q.valid).any()
    victim = torch.argmax(torch.where(q.valid, q.deadline, -1)).reshape(1)
    evict = q.deadline[victim][0] > deadline
    write = mask & (has_free | evict)
    widx = torch.where(has_free, free_slot, victim)

    def put(buf, val):
        val = torch.as_tensor(val, dtype=buf.dtype, device=dev)
        buf[widx] = torch.where(write, val, buf[widx][0])[None]

    tree_map(put, q.payload, payload)
    put(q.node_id, node_id)
    put(q.arrival, arrival)
    put(q.deadline, deadline)
    q.valid[widx] = write | q.valid[widx]
    dropped = mask & ~has_free
    return q._replace(
        cursor=torch.where(write, (widx[0] + 1) % cap,
                           q.cursor).to(torch.int32),
        drops_overflow=q.drops_overflow + dropped.to(torch.int32)), dropped


def queue_push(q: PayloadQueue, payload: Any, node_id, arrival, deadline,
               mask=True) -> tuple[PayloadQueue, torch.Tensor]:
    """Insert one entry; returns ``(queue, dropped)``.

    The entry lands in the first free slot at or after the ring cursor.
    When the queue is full the latest-deadline entry loses: an incoming
    payload with an earlier deadline evicts the worst resident (ties: the
    lowest slot); otherwise the incoming payload is discarded.  Either way
    one payload is dropped and ``drops_overflow`` increments.
    ``mask=False`` makes the push a no-op."""
    return _push_inplace(_clone(q), payload, node_id, arrival, deadline,
                         mask)


def _scatter_rows(buf: torch.Tensor, target: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``buf`` with rows ``vals`` written at ``target``; a target equal to
    ``len(buf)`` writes nowhere (the reference's ``mode="drop"``)."""
    ext = torch.cat([buf, buf[:1]])
    ext[target] = vals.to(buf.dtype)
    return ext[:-1]


def _scatter(q: PayloadQueue, payloads: Any, node_ids, arrivals, deadlines,
             target: torch.Tensor, written: torch.Tensor,
             n_dropped) -> PayloadQueue:
    """Write the rows with ``written`` at ``target`` (``cap`` elsewhere);
    the cursor follows the last row written, the drops add ``n_dropped``."""
    cap = q.valid.shape[0]
    a = written.shape[0]
    last = torch.argmax(torch.where(
        written, torch.arange(a, device=written.device), -1)).reshape(1)
    return PayloadQueue(
        payload=tree_map(lambda buf, v: _scatter_rows(buf, target, v),
                         q.payload, payloads),
        node_id=_scatter_rows(q.node_id, target, node_ids),
        arrival=_scatter_rows(q.arrival, target, arrivals),
        deadline=_scatter_rows(q.deadline, target, deadlines),
        valid=_scatter_rows(q.valid, target,
                            torch.ones_like(written)),
        cursor=torch.where(written.any(), (target[last][0] + 1) % cap,
                           q.cursor).to(torch.int32),
        drops_overflow=(q.drops_overflow + n_dropped).to(torch.int32))


def _fill_targets(q: PayloadQueue, mask: torch.Tensor):
    """The i-th masked entry's free slot in ring order (the sequential
    walk's slot while free slots remain), the entry ranks and the number
    of free slots."""
    cap = q.valid.shape[0]
    ring = _ring_order(q)
    slot_rank = torch.argsort(torch.where(q.valid, cap + ring, ring),
                              stable=True)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1          # (A,)
    n_free = (~q.valid).sum()
    fill = mask & (rank < n_free)
    target = slot_rank[torch.clamp(rank, 0, cap - 1)]
    return torch.where(fill, target, cap), fill, rank, n_free


def push_lane(q: PayloadQueue, payloads: Any, node_ids: torch.Tensor,
              arrival, deadline, mask: torch.Tensor
              ) -> tuple[PayloadQueue, torch.Tensor]:
    """Push a lane whose entries share one ``arrival`` and one ``deadline``
    (scalars or () tensors), exactly as the sequential walk would, with no
    host synchronisation; returns ``(queue, n_dropped)``.

    With one incoming deadline ``d`` the walk is closed-form: the masked
    entries fill the free slots in ring order; each later one drops one
    payload, evicting, while any resident's deadline is above ``d``, the
    next of them in (deadline descending, slot ascending) order (what the
    walk's victim choice visits, since an entry it writes has deadline
    ``d`` and is never chosen), and is itself dropped after that."""
    cap = q.valid.shape[0]
    dev = q.valid.device
    mask = mask.to(torch.bool)
    a = mask.shape[0]
    d = torch.as_tensor(deadline, dtype=torch.int32, device=dev)
    target, fill, rank, n_free = _fill_targets(q, mask)
    cand = q.valid & (q.deadline > d)
    key = torch.where(cand, -q.deadline.to(torch.int64), 2 ** 40)
    victims = torch.argsort(key, stable=True)
    later = rank - n_free                    # rank among the overflow rows
    evict = mask & ~fill & (later < cand.sum())
    target = torch.where(evict, victims[torch.clamp(later, 0, cap - 1)],
                         target)
    n_dropped = (mask & ~fill).sum().to(torch.int32)
    full = torch.full((a,), 0, dtype=torch.int32, device=dev)
    q = _scatter(q, payloads, node_ids, full + arrival, full + d, target,
                 fill | evict, n_dropped)
    return q, n_dropped


def queue_push_batch(q: PayloadQueue, payloads: Any, node_ids, arrivals,
                     deadlines, mask) -> tuple[PayloadQueue, torch.Tensor]:
    """Push ``A`` stamped entries (leaves with leading axis A) in order;
    returns ``(queue, n_dropped)``.  Rows with ``mask=False`` are skipped.

    When every masked entry fits the free slots, one vectorized scatter
    does the insert; otherwise the entries are walked one by one with the
    latest-deadline drop policy (a Python loop).  Deciding which reads two
    counts, one synchronisation on a CUDA tensor."""
    dev = q.valid.device
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    node_ids = torch.as_tensor(node_ids, dtype=torch.int32, device=dev)
    arrivals = torch.as_tensor(arrivals, dtype=torch.int32, device=dev)
    deadlines = torch.as_tensor(deadlines, dtype=torch.int32, device=dev)
    n_in, n_free = mask.sum(), (~q.valid).sum()
    if bool(n_in <= n_free):
        target, fill, _, _ = _fill_targets(q, mask)
        return _scatter(q, payloads, node_ids, arrivals, deadlines, target,
                        fill, 0), torch.zeros((), dtype=torch.int32,
                                              device=dev)
    q = _clone(q)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(mask.shape[0]):
        q, drop = _push_inplace(q, tree_map(lambda x: x[i], payloads),
                                node_ids[i], arrivals[i], deadlines[i],
                                mask[i])
        dropped = dropped + drop.to(torch.int32)
    return q, dropped
