"""Production mesh construction.

PyTorch counterpart of :mod:`repro.launch.mesh`: named
``torch.distributed.device_mesh.DeviceMesh``es over the process group the
caller initialized, as functions, so importing this module touches no
device or group.

Topology: pods of 256 devices arranged (16, 16):
  * single-pod: (16 data, 16 model) — FSDP x TP inside the pod;
  * multi-pod:  (2 pod, 16 data, 16 model) — the "pod" axis is data-parallel
    across the pods (the gradient all-reduce crosses it).

Both raise ``ValueError`` naming the two sizes when the world is not the
mesh's size: nothing falls back to a smaller or replicated layout.
"""
from __future__ import annotations

import math

from ..sharding import make_mesh

__all__ = ["PRODUCTION_SHAPES", "make_production_mesh", "make_mesh_for"]

# (shape, axis names) of the single-pod and multi-pod meshes
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh_for(shape: tuple[int, ...], axes: tuple[str, ...],
                  device_type: str | None = None):
    """A mesh of ``shape`` with dims named ``axes`` over the whole
    initialized process group (elastic re-mesh, tests).  ``device_type``
    defaults to ``"cuda"`` on a NCCL group and ``"cpu"`` otherwise."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh_for needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first")
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"a {shape} mesh holds {math.prod(shape)} ranks, and the "
            f"process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return make_mesh(shape, axes, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh_for(shape, axes, device_type)
