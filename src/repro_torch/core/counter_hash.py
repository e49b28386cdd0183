"""Counter-based random words in integer tensor ops.

One key a row: element ``e`` of the row is MurmurHash3's 32-bit finalizer
of (row key, golden-ratio spread of ``e``), so every element is a pure
function of (key, e) and the same on every device and for any batch the
row sits in.  The top 24 bits of a word give a uniform in (0, 1], exact in
float32; Box-Muller turns two uniforms into a normal.  The host tier's
recovery noise (:func:`repro_torch.host.server.counter_noise`) and the
fleet's per-node keyed noise (:func:`repro_torch.serving.fleet.
draw_slot_noise_keyed`) are both drawn this way.

Words are int64 tensors holding values in ``[0, 2**32)``.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = ["MASK32", "mul32", "fmix32", "counters", "counter_words",
           "word_uniforms", "box_muller"]

MASK32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for values in ``[0, 2**32)``."""
    return (a * b) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 words in ``[0, 2**32)``."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


# never evicted: a captured serve or fleet graph (host/server.py,
# serving/fleet.py) reads it
@functools.lru_cache(maxsize=None)
def counters(n: int, device: torch.device) -> torch.Tensor:
    """(n,) the element counters' golden-ratio spread, made once per size."""
    e = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    return mul32(e, 0x9E3779B1)


def counter_words(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) words: element ``e`` of row ``b`` hashes (``keys[b]``, e)."""
    return fmix32(keys[:, None] ^ counters(n, keys.device))


def word_uniforms(h: torch.Tensor) -> torch.Tensor:
    """Uniforms in (0, 1] from the top 24 bits of each word, exact in
    float32."""
    return ((h >> 8) + 1).to(torch.float32) * (2.0 ** -24)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two tensors of uniforms in (0, 1]."""
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
