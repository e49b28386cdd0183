"""Checkpointing with atomic commit and restart semantics.

PyTorch counterpart of :mod:`repro.checkpoint.store`, in the same on-disk
format, so that a checkpoint written by either package restores in the
other (float32 and int32 leaves):

* a checkpoint is a directory ``step_<k>`` (ten digits) of one ``.npy`` per
  tree leaf, named by its key path in ``jax.tree_util``'s order
  (``params/runs/0/wq`` is ``params__runs__0__wq.npy``), plus a
  ``MANIFEST.json`` written LAST into a ``.tmp`` directory that
  ``os.replace`` then commits — a checkpoint without a manifest is an
  aborted write and is ignored and removed;
* restore takes a template tree of tensors and gives each leaf the
  template's shape check, dtype and device (``shardings=`` waits for the
  LM sharding rules, ROADMAP Queue 1 item 6.4);
* ``keep`` bounds the retained checkpoints (the oldest pruned after a
  commit).

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits under the
manifest dtype ``"bfloat16"``.  A file of two-byte void records (what
``np.save`` writes for the reference's ``ml_dtypes`` bfloat16 arrays) is
read as the same bits.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..tree import leaves_with_paths, path_name, unflatten_like

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps"]

_MANIFEST = "MANIFEST.json"


def _flatten(tree) -> dict:
    return {path_name(p): leaf for p, leaf in leaves_with_paths(tree)}


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and os.path.exists(
                os.path.join(root, d, _MANIFEST)):
            steps.append(int(d.split("_")[1]))
    return sorted(steps)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and its manifest dtype."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(root: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` at ``step``; atomic via tmp-dir + manifest-last."""
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": dtype}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # prune
    for s in list_steps(root)[:-keep]:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
    # drop aborted writes
    for d in os.listdir(root):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    return final


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")      # keeps a 0-dim leaf 0-dim
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(root: str, step: int, template):
    """Restore ``step`` into the structure of ``template``, a tree of
    tensors: each leaf gets its template's dtype (cast as the reference's
    ``astype`` casts) and device, and must have its shape."""
    d = _step_dir(root, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    meta = manifest["leaves"]
    out = []
    for name, ref in _flatten(template).items():
        if name not in meta:
            raise KeyError(f"checkpoint at step {step} missing leaf {name}")
        arr = np.load(os.path.join(d, meta[name]["file"]))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        out.append(_from_numpy(arr, meta[name]["dtype"]).to(
            device=ref.device, dtype=ref.dtype))
    return unflatten_like(template, out)
