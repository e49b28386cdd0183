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
  template's shape check, dtype and device; with ``shardings`` (a tree of
  :class:`repro_torch.sharding.NamedSharding`), or a template of DTensors,
  each leaf goes onto its mesh placements — the ``device_put``
  counterpart — so a checkpoint written on one mesh, or unsharded,
  restores onto another (elastic re-mesh);
* a state of DTensors is written leaf by leaf whole, in the same format,
  by rank 0 of the process group: each rank that holds a distinct shard
  of a split leaf sends it to rank 0, which writes it into its box of the
  memory-mapped file, so no rank holds more than one shard of it; a
  restore onto a mesh reads each rank's box alone.  The other ranks wait
  at a barrier until the commit, so the ranks never race on one
  directory;
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

from ..sharding import is_dtensor
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


def _box(shape, mesh, placements) -> tuple[slice, ...]:
    """The calling rank's box of a global ``shape`` split by
    ``placements`` on ``mesh``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, offset = compute_local_shape_and_global_offset(
        shape, mesh, placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, local))


def _write_split(path: str, leaf, writer: bool) -> str | None:
    """Write the split DTensor ``leaf`` whole to the ``.npy`` file ``path``
    from the writer (rank 0), and return its manifest dtype there.  The
    ranks at index 0 of every mesh dim that does not split the leaf hold
    its distinct shards; each sends its box and its shard to the writer,
    which writes the shard into that box of the memory-mapped file, one
    shard at a time."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    mesh = leaf.device_mesh
    pick = tuple(slice(None) if isinstance(p, Shard) else 0
                 for p in leaf.placements)
    senders = mesh.mesh[pick].reshape(-1).tolist()
    me, ndim = dist.get_rank(), leaf.ndim
    local = leaf.to_local().contiguous()
    box = _box(leaf.shape, mesh, leaf.placements)
    if not writer:
        if me in senders:
            dist.send(torch.tensor([b.start for b in box] +
                                   [b.stop for b in box], dtype=torch.int64,
                                   device=local.device), dst=0)
            dist.send(local.reshape(-1).view(torch.uint8), dst=0)
        return None
    own, dtype = _to_numpy(local)
    out = np.lib.format.open_memmap(path, mode="w+", dtype=own.dtype,
                                    shape=tuple(leaf.shape))
    for src in senders:
        if src == me:
            out[box] = own
            continue
        head = torch.empty(2 * ndim, dtype=torch.int64, device=local.device)
        dist.recv(head, src=src)
        lo, hi = head.tolist()[:ndim], head.tolist()[ndim:]
        shard = torch.empty([b - a for a, b in zip(lo, hi)],
                            dtype=leaf.dtype, device=local.device)
        dist.recv(shard.reshape(-1).view(torch.uint8), src=src)
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = _to_numpy(shard)[0]
    out.flush()
    return dtype


def save_checkpoint(root: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` at ``step``; atomic via tmp-dir + manifest-last.  A
    tree with DTensor leaves is a collective: call it on every rank."""
    flat = _flatten(tree)
    placed = any(is_dtensor(x) for x in flat.values())
    if placed:
        import torch.distributed as dist
        writer = dist.get_rank() == 0
    else:
        writer = True
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if writer:
        os.makedirs(root, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in flat.items():
        fname = name.replace("/", "__") + ".npy"
        if is_dtensor(leaf):
            if any(p.is_shard() for p in leaf.placements):
                dtype = _write_split(os.path.join(tmp, fname), leaf, writer)
                if writer:
                    manifest["leaves"][name] = {
                        "file": fname, "shape": list(leaf.shape),
                        "dtype": dtype}
                continue
            leaf = leaf.to_local()               # replicated: rank 0's copy
        if not writer:
            continue
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": dtype}
    if writer:
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
    if placed:
        dist.barrier()
    return final


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")      # keeps a 0-dim leaf 0-dim
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_checkpoint(root: str, step: int, template, shardings=None):
    """Restore ``step`` into the structure of ``template``, a tree of
    tensors: each leaf gets its template's dtype (cast as the reference's
    ``astype`` casts) and must have its (global) shape.  With
    ``shardings``, a tree of ``NamedSharding`` like ``template``, each
    leaf becomes a DTensor on its sharding's mesh and placements, every
    rank keeping its own shard; without, a DTensor template leaf's own
    placements are kept, and a plain one's device."""
    from torch.distributed.tensor import DTensor

    d = _step_dir(root, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    meta = manifest["leaves"]
    out = []
    for path, ref in leaves_with_paths(template):
        name = path_name(path)
        if name not in meta:
            raise KeyError(f"checkpoint at step {step} missing leaf {name}")
        arr = np.load(os.path.join(d, meta[name]["file"]), mmap_mode="r")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        sh = shardings
        for key in (path if shardings is not None else ()):
            sh = sh[key]
        if sh is None and is_dtensor(ref):
            mesh, placements = ref.device_mesh, ref.placements
        elif sh is not None:
            mesh, placements = sh.mesh, sh.placements
        else:
            leaf = _from_numpy(np.array(arr), meta[name]["dtype"])
            out.append(leaf.to(device=ref.device, dtype=ref.dtype))
            continue
        box = _box(arr.shape, mesh, placements)
        local = _from_numpy(np.array(arr[box]), meta[name]["dtype"])
        whole = torch.empty(arr.shape, device="meta")
        out.append(DTensor.from_local(
            local.to(device=_mesh_device(mesh), dtype=ref.dtype), mesh,
            placements, run_check=False, shape=whole.shape,
            stride=whole.stride()))
    return unflatten_like(template, out)
