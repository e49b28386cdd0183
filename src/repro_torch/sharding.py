"""The fleet's node axis over ``torch.distributed``.

PyTorch counterpart of the fleet half of :mod:`repro.sharding`.  A JAX
``Mesh`` and a ``shard_map`` manual region become a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named from
``("pod", "data")`` and one process a rank: every rank calls the same entry
point with the same global inputs, moves only its own node tile to its
device, and meets the other ranks in the collectives below.  There is no
``shard_map`` counterpart, because each process already is the manual
region.

* :data:`FLEET_RULES` and :func:`node_mesh_axes`: the logical ``"nodes"``
  axis resolved against a mesh, as ``(axes, quantum)``;
* :func:`make_mesh`: a named mesh over an initialized process group;
* :func:`tile_bounds` and :func:`tile_index`: the padded fleet and a rank's
  ``[start, stop)`` tile in pod-major order;
* :func:`node_shard`: all of that for the calling rank, with the group its
  collectives run on; :func:`group_shard`: a whole process group as one
  data axis (the compressed gradient reduction's);
* :func:`all_reduce_sum`, :func:`all_gather_tiles` and
  :func:`exchange`: the collectives the sharded fleet driver issues.  Gloo
  refuses CUDA tensors in ``all_gather`` and in point-to-point sends, so
  those two stage such a tensor through the CPU; ``all_reduce`` takes it
  on the card.  Neither backend carries int16, so the wire format's int16
  codes travel as their bytes.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Sequence

import torch

__all__ = ["FLEET_RULES", "NodeShard", "node_mesh_axes", "make_mesh",
           "tile_bounds", "tile_index", "node_shard", "group_shard",
           "all_reduce_sum",
           "all_gather_tiles", "exchange"]

ShardingRules = Mapping[str, "tuple[str, ...] | str | None"]

# The fleet's one sharded axis is its node axis: stacked node state, harvest
# traces and per-node streams split their leading node dim over
# ("pod", "data"); the signature bank and every weight tree are replicated,
# and only the fleet aggregates cross ranks.
FLEET_RULES: ShardingRules = {
    "nodes": ("pod", "data"),
    "signatures": None,       # memo bank: replicated
    "params": None,           # qDNN / host DNN / generator weights
}


def _dims(mesh) -> dict[str, int]:
    names = tuple(mesh.mesh_dim_names or ())
    return dict(zip(names, tuple(mesh.shape)))


def node_mesh_axes(mesh, rules: ShardingRules = FLEET_RULES
                   ) -> tuple[tuple[str, ...], int]:
    """Resolve the ``"nodes"`` logical axis against ``mesh`` (anything with
    ``mesh_dim_names`` and ``shape``, as a ``DeviceMesh`` has).

    Returns ``(axes, quantum)``: the mesh dims the node axis splits over
    (rule axes absent from the mesh are dropped, so the same table serves
    ("data",) and ("pod", "data") meshes) and their total size, the
    multiple a fleet is padded to."""
    rule = rules.get("nodes") or ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    dims = _dims(mesh)
    axes = tuple(a for a in axes if a in dims)
    return axes, (math.prod(dims[a] for a in axes) if axes else 1)


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """``init_device_mesh(device_type, shape, mesh_dim_names=names)`` over
    the process group the caller initialized (the default rank order: the
    first dim is the slowest).  Without an initialized group this raises
    rather than start one from the environment."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def tile_bounds(n: int, quantum: int, index: int
                ) -> tuple[int, int, int]:
    """``(pad, start, stop)``: the inert nodes that make ``n`` a multiple of
    ``quantum``, and tile ``index``'s rows of the padded fleet."""
    if not 0 <= index < quantum:
        raise ValueError(f"tile index {index} outside [0, {quantum})")
    pad = (-n) % quantum
    size = (n + pad) // quantum
    return pad, index * size, (index + 1) * size


def tile_index(coords: Mapping[str, int], sizes: Mapping[str, int],
               axes: Sequence[str]) -> int:
    """A rank's tile position: its coordinates on ``axes`` read row-major
    (the first axis slowest), the order JAX's ``P(("pod", "data"))`` lays
    the node axis out in."""
    index = 0
    for a in axes:
        index = index * sizes[a] + coords[a]
    return index


class NodeShard(NamedTuple):
    """The calling rank's place in the fleet's node layout."""

    axes: tuple[str, ...]        # mesh dims the node axis splits over
    quantum: int                 # ranks the node axis splits over
    index: int                   # this rank's tile, pod-major
    coords: dict                 # this rank's coordinate on each dim
    sizes: dict                  # each dim's size
    group: object                # the process group of the collectives
    order: tuple[int, ...]       # group rank holding tile 0, 1, ...
    grid: torch.Tensor           # the mesh's global ranks, one per coordinate
    backend: str

    def bounds(self, n: int) -> tuple[int, int, int]:
        """``(pad, start, stop)`` of this rank's tile of an ``n``-node
        fleet."""
        return tile_bounds(n, self.quantum, self.index)


def node_shard(mesh) -> NodeShard:
    """Resolve a ``DeviceMesh`` for the fleet's node axis on this rank.

    Raises ``ValueError`` for anything but a ``DeviceMesh``, for a mesh
    with none of the :data:`FLEET_RULES` node axes, and for a mesh with a
    dim that is not one (the node axis is the fleet's only sharded axis)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__name__}")
    axes, quantum = node_mesh_axes(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if not axes:
        raise ValueError(
            f"mesh {names} has none of the FLEET_RULES node axes")
    extra = [a for a in names if a not in axes]
    if extra:
        raise ValueError(
            f"mesh dims {extra} are not FLEET_RULES node axes "
            f"{FLEET_RULES['nodes']}: the fleet shards its node axis only")
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    elif mesh.size() == dist.get_world_size():
        group = dist.group.WORLD
    else:
        raise ValueError(
            f"a {mesh.ndim}-D mesh must span the whole process group "
            f"({dist.get_world_size()} ranks), got {mesh.size()} ranks")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    sizes, coords = _dims(mesh), dict(zip(names, coord))
    grid = mesh.mesh.cpu()
    order = []
    for i in range(quantum):                 # tile i's coordinates
        at = {}
        for a in reversed(axes):
            i, at[a] = divmod(i, sizes[a])
        order.append(dist.get_group_rank(
            group, int(grid[tuple(at[a] for a in names)])))
    return NodeShard(axes=axes, quantum=quantum,
                     index=tile_index(coords, sizes, axes), coords=coords,
                     sizes=sizes, group=group, order=tuple(order), grid=grid,
                     backend=str(dist.get_backend(group)))


def group_shard(group=None) -> NodeShard:
    """The ranks of ``group`` (the default group when None) as one
    ``("data",)`` axis in group-rank order: the calling rank's tile is its
    group rank.  Needs an initialized process group."""
    import torch.distributed as dist
    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    return NodeShard(axes=("data",), quantum=world, index=rank,
                     coords={"data": rank}, sizes={"data": world},
                     group=group, order=tuple(range(world)),
                     grid=torch.tensor(dist.get_process_group_ranks(group)),
                     backend=str(dist.get_backend(group)))


def _staged(x: torch.Tensor, shard: NodeShard) -> bool:
    """Does this collective take ``x`` through the CPU?  Gloo's
    ``all_gather`` and point-to-point ops accept CPU tensors only."""
    return shard.backend == "gloo" and x.device.type != "cpu"


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives move it: int16 (the wire format's center
    codes), which neither NCCL nor gloo carries, as its uint8 bytes (the
    last dim doubled); every other dtype as it is."""
    return x.view(torch.uint8) if x.dtype == torch.int16 else x


def all_reduce_sum(x: torch.Tensor, shard: NodeShard) -> torch.Tensor:
    """The sum of ``x`` over the shard's ranks (a new tensor)."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=shard.group)
    return out


def all_gather_tiles(x: torch.Tensor, shard: NodeShard, dim: int = 0
                     ) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along
    ``dim`` in tile order, so a node-axis ``dim`` comes back in the global
    pod-major layout."""
    import torch.distributed as dist
    src = _as_bytes(x.movedim(dim, 0).contiguous())
    if _staged(src, shard):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(shard.quantum)]
    dist.all_gather(parts, src, group=shard.group)
    out = torch.cat([parts[g] for g in shard.order], dim=0)
    return out.to(x.device).view(x.dtype).movedim(0, dim)


def exchange(x: torch.Tensor, shard: NodeShard, dst: int, src: int
             ) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive a tensor of its shape
    and dtype from global rank ``src`` (the identity when both are this
    rank)."""
    import torch.distributed as dist
    me = dist.get_rank()
    if dst == me and src == me:
        return x
    send = _as_bytes(x.contiguous())
    if _staged(send, shard):
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, shard.group),
           dist.P2POp(dist.irecv, recv, src, shard.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device).view(x.dtype)
