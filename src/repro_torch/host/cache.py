"""Signature-keyed recovery cache: the paper's D0 memoization, host side.

PyTorch counterpart of :mod:`repro.host.cache`.  Each payload is keyed by a
64-bit signature of its quantized leaves (two independent 32-bit mixes),
and a hit returns the cached logits.  The host server derives a payload's
recovery noise from the same signature, so a hit is a recomputation.

The signature is the reference's uint32 arithmetic, word for word.
PyTorch has few uint32 ops, so the words live in int64 tensors holding
values in ``[0, 2**32)``: every step masks with ``0xFFFFFFFF``.  A 32 x
32-bit product overflows int64 in its high bits, which wrap in two's
complement on the CPU and on the card; the low 32 bits, the only ones
kept, are exact.  Signatures are (..., 2) int64.

Eviction is FIFO through a ring cursor.  A batch insert is one vectorized
scatter: the inserted rows land at ``(cursor + exclusive rank) % cap``,
and only the last ``cap`` of them can survive, so the rows scattered have
distinct targets.  Nothing here reads a tensor on the host but
:func:`cache_stats`.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from ..core.counter_hash import mul32 as _mul32

__all__ = ["RecoveryCache", "cache_init", "cache_stats",
           "payload_signature", "batch_signatures", "cache_lookup_batch",
           "cache_insert_batch"]

_MASK = 0xFFFFFFFF
# the reference's Knuth/FNV-flavoured odd constants for the two mixes
_MIX_SEEDS = (2654435761, 2246822519)


class RecoveryCache(NamedTuple):
    sig: torch.Tensor       # (cap, 2) int64 in [0, 2**32) — the signature
    logits: torch.Tensor    # (cap, L) float32 — memoized host logits
    valid: torch.Tensor     # (cap,) bool
    cursor: torch.Tensor    # () int32 — FIFO insert position (not wrapped)
    hits: torch.Tensor      # () int32
    misses: torch.Tensor    # () int32


def cache_init(capacity: int, n_classes: int, device=None) -> RecoveryCache:
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return RecoveryCache(
        sig=z((capacity, 2), torch.int64),
        logits=z((capacity, n_classes), torch.float32),
        valid=z((capacity,), torch.bool), cursor=z((), torch.int32),
        hits=z((), torch.int32), misses=z((), torch.int32))


def _leaf_words(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B, n) int32 bit patterns of a leaf with leading axis B: float leaves
    bitcast (so -0.0 != 0.0 and a NaN keeps its bits), integer leaves
    sign-extended, which wraps them in two's complement once masked."""
    if x.is_floating_point():
        x = x.to(torch.float32).contiguous().view(torch.int32)
    return x.reshape(batch, -1).to(torch.int32)


# never evicted: a captured serve graph (server.py) reads it
@functools.lru_cache(maxsize=None)
def _multipliers(width: int, device: torch.device) -> torch.Tensor:
    """(2, W) the per-position multiplier streams of the two mixes: an
    avalanched function of (position, seed), odd; made once per width."""
    idx = torch.arange(width, dtype=torch.int64, device=device)
    rows = []
    for seed in _MIX_SEEDS:
        mult = (_mul32(idx, 2654435761) + seed) & _MASK
        mult = _mul32(mult ^ (mult >> 15), 2246822519)
        rows.append((mult ^ (mult >> 13)) | 1)
    return torch.stack(rows)


def batch_signatures(payload: Any) -> torch.Tensor:
    """(B, 2) signatures of a batch of entries (NamedTuple leaves with a
    leading axis B), the leaves concatenated in field order; both mixes
    (``repro/host/cache.py`` ``_mix``) at once: xorshifted words times the
    multiplier stream, wrap-summed, then avalanched."""
    leaves = list(payload)
    b = leaves[0].shape[0]
    words = torch.cat([_leaf_words(x, b) for x in leaves], dim=1
                      ).to(torch.int64) & _MASK                   # (B, W)
    mult = _multipliers(words.shape[1], words.device)             # (2, W)
    h = _mul32((words ^ (words >> 16))[:, None, :], mult).sum(dim=-1) \
        & _MASK                                                   # (B, 2)
    h = _mul32(h ^ (h >> 15), 2246822519)
    return h ^ (h >> 13)


def payload_signature(payload: Any) -> torch.Tensor:
    """(2,) signature of ONE entry's payload (a NamedTuple of tensors);
    equal payloads, bit for bit, get equal signatures."""
    return batch_signatures(type(payload)(*(x[None] for x in payload)))[0]


def cache_lookup_batch(cache: RecoveryCache, sigs: torch.Tensor,
                       valid: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-match lookup of (B, 2) signatures; returns ``(hit (B,) bool,
    logits (B, L))``: the logits of the lowest matching slot (slot 0 where
    none matches; callers select on ``hit``).  Rows with ``valid=False``
    never hit."""
    cap = cache.valid.shape[0]
    match = cache.valid[None, :] & (
        sigs[:, None, :] == cache.sig[None, :, :]).all(dim=-1)    # (B, cap)
    hit = match.any(dim=1) & valid
    slots = torch.arange(cap, device=sigs.device)
    idx = torch.where(match, slots, cap).amin(dim=1)
    return hit, cache.logits[torch.where(idx == cap, 0, idx)]


def cache_insert_batch(cache: RecoveryCache, sigs: torch.Tensor,
                       logits: torch.Tensor, insert: torch.Tensor
                       ) -> RecoveryCache:
    """FIFO-insert the rows with ``insert=True`` (typically ``valid & ~hit``)
    at the ring cursor, as the reference's row-by-row walk does.  Duplicate
    signatures within one batch insert twice; later lookups match the
    lower slot."""
    cap = cache.valid.shape[0]
    ins = insert.to(torch.int64)
    rank = torch.cumsum(ins, 0) - ins                         # exclusive
    total = ins.sum()
    keep = insert & (rank >= total - cap)
    target = torch.where(keep, (cache.cursor + rank) % cap, cap)

    def put(buf, vals):
        ext = torch.cat([buf, buf[:1]])
        ext[target] = vals.to(buf.dtype)
        return ext[:-1]

    return cache._replace(
        sig=put(cache.sig, sigs), logits=put(cache.logits, logits),
        valid=put(cache.valid, torch.ones_like(insert)),
        cursor=(cache.cursor + total).to(torch.int32))


def cache_stats(cache: RecoveryCache) -> dict:
    """Hit and miss counters as Python numbers (one synchronisation; off
    the hot path)."""
    hits, misses = int(cache.hits), int(cache.misses)
    return {"cache_hits": hits, "cache_misses": misses,
            "cache_hit_rate": hits / max(hits + misses, 1)}
