"""Flash-style exact attention: the forward walks.

PyTorch counterpart of :mod:`repro.models.flash`'s forward walks, in the
same chunk order and arithmetic: the running max and sum in float32, the PV
product in the input dtype, each walk also returning the row log-sum-exp
that a recompute backward reads.  Without a backward the walks are
:mod:`.layers`' pair-chunked and banded walks; they part when training
brings the backward walks.

* :func:`flash_causal_attention` — lower-triangular chunk-pair walk
  (FLOPs = T(T+1)/2 pairs; no masked-garbage compute).
* :func:`flash_banded_attention` — sliding-window band walk
  (FLOPs ~ S*(window+chunk)).

The backward walks come with training; until then a call whose inputs
require gradients raises.  Shapes follow layers.py: q (B,S,G,R,D), k/v
(B,T,G,D).
"""
from __future__ import annotations

import torch

from .layers import _banded_walk as _banded_fwd_walk
from .layers import _causal_walk as _causal_fwd_walk

__all__ = ["flash_causal_attention", "flash_banded_attention"]


def _forward_only(*xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise NotImplementedError(
            "the flash attention backward walks come with training "
            "(ROADMAP Queue 1 item 6.2); call under torch.no_grad()")


def flash_causal_attention(q, k, v, chunk: int = 512,
                           softcap: float = 0.0) -> torch.Tensor:
    """Causal attention by the lower-triangular chunk-pair walk."""
    _forward_only(q, k, v)
    return _causal_fwd_walk(q, k, v, chunk, softcap)[0]


def flash_banded_attention(q, k, v, window: int, chunk: int = 512,
                           softcap: float = 0.0) -> torch.Tensor:
    """Sliding-window attention by the per-chunk KV-band walk."""
    _forward_only(q, k, v)
    return _banded_fwd_walk(q, k, v, window, chunk, softcap)[0]
