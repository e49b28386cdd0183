"""Trees of tensors in JAX's order.

The training state is a tree of dicts and lists with tensors at its leaves,
the layout of the reference's pytrees.  JAX flattens a dict by its sorted
keys and a list or tuple in order; the global gradient norm sums its leaves
in that order and a checkpoint names each leaf by its key path, so both
sides walk a tree the same way through these helpers.  A DTensor is a
leaf like any tensor (its whole value is ``full_tensor()``, a
collective; ``convert.to_numpy`` takes that).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves_with_paths", "leaves", "unflatten_like", "tree_map",
           "path_name"]


def leaves_with_paths(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(key path, leaf)`` pairs in ``jax.tree_util``'s order: a dict's
    keys sorted, a list's or tuple's items in order; ``None`` holds no
    leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util``'s order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_name(path: tuple) -> str:
    """A key path as the reference's checkpoint names it
    (``params/runs/0/wq``)."""
    return "/".join(str(p) for p in path)


def unflatten_like(tree, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` (in :func:`leaves`' order)
    at its leaves."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            items = [build(v) for v in t]
            if hasattr(t, "_fields"):
                return type(t)(*items)
            return type(t)(items)
        return None if t is None else next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structures")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])
