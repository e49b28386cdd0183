"""Trees of tensors as the buffers of a captured CUDA graph.

A captured graph reads and writes fixed addresses.  Its callers copy their
inputs into the graph's own buffers before a replay, hand out clones of
what it wrote after one, and key the capture on the layout of what it was
built for.  The host serve slot (:mod:`repro_torch.host.server`) and the
fleet's slot loop (:mod:`repro_torch.serving.fleet`) share these helpers.

A tree is a NamedTuple or dict of tensors (nested); a ``None`` stands for
an absent part, such as a state without telemetry lanes, and stays None.
"""
from __future__ import annotations

import torch

__all__ = ["tree_map", "copy_leaves", "clone", "layout"]


def tree_map(fn, *trees):
    """``fn`` over the leaves of NamedTuples or dicts of tensors; a None
    (an absent part, such as a state without telemetry lanes) stays None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def copy_leaves(dst, src) -> None:
    """Copy each tensor of the tree ``src`` into its place in ``dst``, one
    multi-tensor copy per dtype."""
    groups = {}

    def pair(d, s):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)

    tree_map(pair, dst, src)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def clone(tree):
    """A copy of ``tree`` that the caller owns."""
    new = tree_map(torch.empty_like, tree)
    copy_leaves(new, tree)
    return new


def layout(*trees, addresses: bool = False) -> tuple:
    """Shape and dtype of every tensor in ``trees`` and, with
    ``addresses``, its data pointer and strides: what a captured graph was
    built for."""
    seen = []

    def visit(t):
        seen.append((t.shape, t.dtype) + (
            (t.data_ptr(), t.stride()) if addresses else ()))
        return t

    for tree in trees:
        tree_map(visit, tree)
    return tuple(seen)
