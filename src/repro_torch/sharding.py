"""Logical-axis sharding over ``torch.distributed``.

PyTorch counterpart of :mod:`repro.sharding`.  A JAX ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the
reference's axis names (``"pod"``, ``"data"``, ``"model"``), one process a
rank.

The LM half: models annotate parameters and activations with *logical*
names ("batch", "heads", "ff", "embed", ...); a rule table maps each name
to mesh axes, and :func:`spec_for` resolves a logical spec against a mesh
with the reference's three drops (axes absent from the mesh, the tail of a
rule while the rest does not divide the dimension, a mesh axis already
used).  :func:`placements_for` turns the resolved spec into DTensor
placements: a mesh dim named on tensor dim ``i`` is ``Shard(i)``, any
other ``Replicate()``.  :func:`place` puts a tree of tensors onto a mesh by
a tree of :class:`NamedSharding`; :func:`constrain`, the counterpart of
``with_sharding_constraint``, redistributes a DTensor activation inside a
:func:`use_sharding` context and is a no-op outside one.

The fleet half: the node axis of the sharded fleet driver, where every
rank calls the same entry point with the same global inputs, moves only
its own node tile to its device, and meets the other ranks in the
collectives below (each process already is the reference's ``shard_map``
manual region):

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
  codes travel as their bytes.  Over NCCL all three stay on the device.
* :func:`collective_counts`: the calls and bytes of those collectives (and
  of :func:`repro_torch.obs.metrics_psum`'s all-reduce) this process
  issued, counted on the host at issue.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Mapping, NamedTuple, Sequence

import torch

__all__ = ["DEFAULT_RULES", "FSDP_RULES", "DP_TP_RULES", "PURE_DP_RULES",
           "FLEET_RULES", "ShardingRules", "NamedSharding", "use_sharding",
           "current_context", "spec_for", "placements_for", "constrain",
           "named_sharding", "tree_named_shardings", "place",
           "strip_rules", "take_last", "is_dtensor", "is_spec",
           "NodeShard", "node_mesh_axes", "make_mesh",
           "tile_bounds", "tile_index", "node_shard", "group_shard",
           "all_reduce_sum", "all_gather_tiles", "exchange",
           "collective_counts"]

# Logical axis -> mesh axis (or tuple of mesh axes, major to minor).  Mesh
# axes absent from the active mesh are dropped at resolution time, so one
# table serves the ("data", "model") and ("pod", "data", "model") meshes.
ShardingRules = Mapping[str, "tuple[str, ...] | str | None"]

# FSDP (the default for the big models): a weight's embed dim shards over
# "data" (each weight is gathered where it is used), and the optimizer
# state inherits the same placements.
FSDP_RULES: ShardingRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",          # weight d_model dim (FSDP axis)
    "embed_act": None,        # activation d_model dim stays unsharded
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    # head counts that do not divide the model axis are zero-padded to its
    # quantum by the model (cfg.head_pad_multiple), not split on head_dim
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_ff": "model",
    "state": "model",         # SSM / RG-LRU inner state dim
    "conv": None,
    "layers": None,
    "seq_shard": "data",      # long-context activation sequence sharding
    # the decode KV cache's sequence dim shards over "model" when kv_heads
    # cannot (split-KV)
    "kv_seq": "model",
}

# Plain DP+TP: weights replicated over "data", where the gradient
# all-reduce dominates and the coreset gradient compression acts.
DP_TP_RULES: ShardingRules = dict(FSDP_RULES, embed=None)

# Pure DP for models too small to feed a tensor axis (mamba2-130m,
# whisper-small): the batch shards over the whole mesh, weights FSDP over
# "data", no tensor parallelism.
PURE_DP_RULES: ShardingRules = {
    **{k: None for k in FSDP_RULES},
    "batch": ("pod", "data", "model"),
    "embed": "data",
    "layers": None,
}

# The fleet's one sharded axis is its node axis: stacked node state, harvest
# traces and per-node streams split their leading node dim over
# ("pod", "data"); the signature bank and every weight tree are replicated,
# and only the fleet aggregates cross ranks.
FLEET_RULES: ShardingRules = {
    **{k: None for k in FSDP_RULES},
    "nodes": ("pod", "data"),
    "signatures": None,       # memo bank: replicated
    "params": None,           # qDNN / host DNN / generator weights
}

DEFAULT_RULES = FSDP_RULES

_ctx = threading.local()


class _Context:
    def __init__(self, mesh, rules: ShardingRules):
        self.mesh = mesh
        self.rules = dict(rules)


def current_context() -> _Context | None:
    """The innermost :func:`use_sharding` context of this thread, or
    None."""
    return getattr(_ctx, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: ShardingRules = DEFAULT_RULES):
    """Make ``mesh`` and ``rules`` the ones :func:`constrain`,
    :func:`spec_for` and :func:`named_sharding` read on this thread."""
    prev = current_context()
    _ctx.ctx = _Context(mesh, rules)
    try:
        yield _ctx.ctx
    finally:
        _ctx.ctx = prev


def _dims(mesh) -> dict[str, int]:
    names = tuple(mesh.mesh_dim_names or ())
    return dict(zip(names, tuple(mesh.shape)))


def _axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size, of a ``DeviceMesh`` or of anything with a
    ``shape`` dict (as a JAX mesh has)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return _dims(mesh)


def strip_rules(rules: ShardingRules, axes) -> dict:
    """``rules`` with the mesh ``axes`` taken out of every rule (the rules
    a manual region over ``axes`` resolves with)."""
    drop = set(axes)

    def strip(rule):
        if rule is None:
            return None
        kept = tuple(a for a in ((rule,) if isinstance(rule, str) else rule)
                     if a not in drop)
        return kept[0] if len(kept) == 1 else (kept or None)

    return {k: strip(v) for k, v in rules.items()}


def spec_for(logical: Sequence[str | None], shape: Sequence[int],
             mesh=None, rules: ShardingRules | None = None) -> tuple:
    """Resolve a logical spec against ``mesh``: a tuple as long as
    ``shape`` of None, a mesh axis name, or a tuple of names (major to
    minor) per dimension.

    Drops (a) mesh axes absent from the mesh, (b) the tail of a rule while
    the rest does not divide the dimension, (c) a mesh axis already used by
    an earlier dimension (first wins).  Without a mesh (none given and no
    context) every dimension is None."""
    ctx = current_context()
    mesh = mesh or (ctx.mesh if ctx else None)
    rules = rules or (ctx.rules if ctx else DEFAULT_RULES)
    if mesh is None:
        return (None,) * len(shape)
    sizes = _axis_sizes(mesh)
    logical = tuple(logical) + (None,) * (len(shape) - len(logical))
    used: set[str] = set()
    out = []
    for name, dim in zip(logical, shape):
        assignment = None
        rule = rules.get(name) if name is not None else None
        if rule is not None:
            axes = (rule,) if isinstance(rule, str) else tuple(rule)
            axes = tuple(a for a in axes if a in sizes and a not in used)
            # the longest prefix of the rule that divides the dimension
            while axes and dim % math.prod(sizes[a] for a in axes) != 0:
                axes = axes[:-1]
            if axes:
                assignment = axes if len(axes) > 1 else axes[0]
                used.update(axes)
        out.append(assignment)
    return tuple(out)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a resolved spec on a ``DeviceMesh``: a mesh
    dim named on tensor dim ``i`` is ``Shard(i)``, any other
    ``Replicate()``; so is a mesh dim of size 1, which splits nothing
    (DTensor would otherwise refuse views that merge such a dim).  A
    tuple of mesh axes on one dim must follow the mesh's dim order
    (DTensor splits by the first mesh dim first, the reference by the
    first axis of the tuple); another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    sizes = _axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"dim {i} splits over {axes}, against the mesh's dim order "
                f"{names}")
        for j in idx:
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A leaf's layout on a mesh: the resolved spec and its placements."""
    mesh: object
    spec: tuple
    placements: tuple


def named_sharding(logical: Sequence[str | None], shape: Sequence[int],
                   mesh=None, rules: ShardingRules | None = None
                   ) -> NamedSharding:
    ctx = current_context()
    mesh = mesh or (ctx.mesh if ctx else None)
    if mesh is None:
        raise ValueError(
            "named_sharding requires a mesh (or use_sharding ctx)")
    spec = spec_for(logical, shape, mesh, rules)
    return NamedSharding(mesh, spec, placements_for(spec, mesh))


def is_dtensor(x) -> bool:
    """Is ``x`` a ``torch.distributed.tensor.DTensor``?"""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_spec(s) -> bool:
    """Is ``s`` a logical spec (a tuple of axis names and Nones)?"""
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in s)


def _zip_specs(fn, spec_tree, tree):
    """``fn(spec, leaf)`` over the leaves of ``tree`` (dicts and lists) and
    the logical specs at the same places of ``spec_tree``."""
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, spec_tree[k], v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_specs(fn, s, v) for s, v in zip(spec_tree, tree)]
    if not is_spec(spec_tree):
        raise ValueError(f"no logical spec for a leaf: {spec_tree!r}")
    return fn(spec_tree, tree)


def tree_named_shardings(spec_tree, shape_tree, mesh,
                         rules: ShardingRules = DEFAULT_RULES):
    """Zip a logical-spec tree against a tree of tensors (``meta`` ones
    will do: only shapes are read) -> a tree of :class:`NamedSharding`."""
    return _zip_specs(
        lambda spec, x: named_sharding(spec, x.shape, mesh, rules),
        spec_tree, shape_tree)


def _place_leaf(x, sh: NamedSharding):
    from torch.distributed.tensor import DTensor, distribute_tensor
    if is_dtensor(x):
        if tuple(x.placements) == tuple(sh.placements):
            return x
        return x.redistribute(sh.mesh, sh.placements)
    d = distribute_tensor(x.detach(), sh.mesh, sh.placements,
                          src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # a view of the whole tensor: give the shard its own storage, so
        # the whole tensor is freed with the caller's reference
        d = DTensor.from_local(local.clone(), sh.mesh, sh.placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


def place(tree, shardings):
    """Each tensor of ``tree`` on the :class:`NamedSharding` at the same
    place of ``shardings``, as a DTensor.  Every rank passes the whole
    tensor and keeps its own shard, in storage of its own, with no
    collective; a DTensor leaf is redistributed to its sharding."""
    def walk(x, sh):
        if isinstance(x, dict):
            return {k: walk(v, sh[k]) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, s) for v, s in zip(x, sh)]
        return _place_leaf(x, sh)

    return walk(tree, shardings)


def constrain(x, *logical: str | None):
    """Redistribute a DTensor to the placements of ``logical`` under the
    current context (``with_sharding_constraint``); a no-op outside a
    context and on a plain tensor."""
    ctx = current_context()
    if ctx is None or not is_dtensor(x):
        return x
    placements = placements_for(spec_for(logical, x.shape, ctx.mesh,
                                         ctx.rules), ctx.mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(ctx.mesh, placements)


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


_COLLECTIVES = {kind: {"calls": 0, "bytes": 0}
                for kind in ("all_reduce", "all_gather", "point_to_point")}


def collective_counts() -> dict:
    """The collectives this process issued, by kind (``all_reduce``,
    ``all_gather``, ``point_to_point``): ``calls`` and ``bytes``, the
    bytes of the tensor this rank put in (an all-gather's own tile, a
    point-to-point exchange's send).  Counted on the host when a call is
    issued, from shapes alone: reading them never synchronises."""
    return {kind: dict(c) for kind, c in _COLLECTIVES.items()}


def _count(kind: str, x: torch.Tensor) -> None:
    c = _COLLECTIVES[kind]
    c["calls"] += 1
    c["bytes"] += x.numel() * x.element_size()


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
    _count("all_reduce", out)
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
    _count("all_gather", src)
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
    _count("point_to_point", send)
    ops = [dist.P2POp(dist.isend, send, dst, shard.group),
           dist.P2POp(dist.irecv, recv, src, shard.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device).view(x.dtype)


def take_last(x, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` along the last dim, one entry per position
    (``index`` has ``x``'s leading shape): ``torch.gather`` for a plain
    tensor.  For a DTensor whose last dim is split, each rank gathers the
    indices that fall in its own slice (zero elsewhere) and the shards'
    values are summed over the splitting mesh dims: one nonzero term each,
    so the sum is exact."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return torch.gather(x, -1, index.long()[..., None])[..., 0]
    last = x.ndim - 1
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    split = [j for j, p in enumerate(x.placements) if p == Shard(last)]
    kept = tuple(Replicate() if j in split else p
                 for j, p in enumerate(x.placements))
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    index = index.redistribute(mesh, kept).to_local().long()
    local = x.to_local()
    width = local.shape[-1]
    chunk = 0
    for j in split:                        # this rank's slice, major first
        chunk = chunk * mesh.size(j) + mesh.get_local_rank(j)
    rel = index - chunk * width
    inside = (rel >= 0) & (rel < width)
    got = torch.gather(local, -1, rel.clamp(0, width - 1)[..., None])[..., 0]
    got = torch.where(inside, got, got.new_zeros(()))
    partial = tuple(Partial() if j in split else p for j, p in enumerate(kept))
    shape = x.shape[:-1]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(got, mesh, partial, run_check=False,
                              shape=shape, stride=stride
                              ).redistribute(mesh, kept)
