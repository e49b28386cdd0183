"""Per-device op analysis of one eager step: FLOPs, memory traffic,
collective bytes and live memory.

PyTorch counterpart of :mod:`repro.launch.hlo_analysis` (``HloStats`` ->
:class:`OpStats`, ``analyze_hlo`` -> :func:`analyze_step`).  The reference
parses the partitioned HLO of a compiled step; the port has no HLO, so it
runs the step once, eagerly, under a ``TorchDispatchMode`` and counts each
op as the calling rank runs it.  Run on fake tensors (the dry run,
:mod:`repro_torch.launch.dryrun`) nothing is allocated and no card is
needed.

The rules of counting are the reference's:

* FLOPs for matrix products and convolutions only, by the formulas of
  ``torch.utils.flop_counter`` (``2 * M * N * K`` for a product);
* ``hbm_bytes``: the operand-plus-output bytes of every op that touches
  memory; views, aliases, allocations of empty tensors and other
  shape-only ops are left out;
* collective bytes: the output's bytes, an all-reduce counted twice (a ring
  is a reduce-scatter and an all-gather).  The functional collectives
  DTensor issues (``_c10d_functional``) and the ``c10d`` ops of
  ``torch.distributed``'s own calls map to the reference's five kinds.

No trip-count correction is needed: the reference multiplies a ``while``
body by its trip count because XLA's program holds each loop once, while
an eager step runs every iteration, so every op is seen as often as it
runs.

Per device: on a DTensor the mode sees the op at its global shape first
and hands it on (``NotImplemented``); DTensor then runs the op on the
calling rank's local shards, and the mode counts those, the collectives
DTensor inserts included.  The ops DTensor runs at global shapes only to
infer its outputs' metadata are not counted.

Live memory: every storage an op creates is tracked until it is freed;
``memory`` holds the reference's ``memory_analysis`` fields per device:
``argument_bytes`` (the arguments' storages), ``output_bytes`` (the
result's), ``temp_bytes`` (the peak of the storages live during the step
that are not arguments) and ``alias_bytes`` (result storages that are
argument storages).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpStats", "analyze_step", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (DTensor's): the output is the returned tensor
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# c10d's in-place ops (torch.distributed's calls): the output is the first
# argument; a send is the receiving rank's recv
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}
# ops that move no data: allocations of uninitialised tensors, aliases and
# the collectives' waits (views are found by their schema)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "wait_tensor", "set_", "resize_",
               "_local_scalar_dense", "send", "barrier", "monitored_barrier",
               "_wrap_tensor_autograd"}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVES})
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVES})
    warnings: list = dataclasses.field(default_factory=list)
    # the step's memory_analysis fields (not part of to_json)
    memory: dict = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_json(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "warnings": self.warnings[:20],
        }


def _nbytes(x) -> int:
    """Bytes of a tensor or (nested) list of tensors, as the op sees them."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    return st, st._cdata


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x):
    return x._local_tensor if _is_dtensor(x) else x


_QUIET = threading.local()


def _quietly(fn):
    """``fn`` with the counting mode letting its ops through uncounted."""
    def wrapped(*args, **kwargs):
        _QUIET.depth = getattr(_QUIET, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _QUIET.depth -= 1
    return wrapped


@contextlib.contextmanager
def _dtensor_bookkeeping():
    """DTensor infers an op's output metadata by running the op once on
    fake tensors at the global shapes: no rank's work, so those runs are
    let through uncounted.  Yields a warning when the hook is not found
    (in another torch), else None."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:          # no distributed build: nothing to hide
        yield None
        return
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        yield ("DTensor's metadata propagation was not found: its global-"
               "shape runs may be counted")
        return
    orig = ShardingPropagator.__dict__[name]
    setattr(ShardingPropagator, name, _quietly(orig))
    try:
        yield None
    finally:
        setattr(ShardingPropagator, name, orig)


class _Counter(TorchDispatchMode):
    """Counts every op the calling rank runs on plain (local) tensors."""

    def __init__(self, stats: OpStats, args_keys: set):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.stats = stats
        self.flop_registry = flop_registry
        self.args_keys = args_keys
        self.live = {}                   # storage key -> bytes
        self.live_bytes = 0
        self.peak = 0
        self.lock = threading.Lock()
        self.refs = []

    def _freed(self, key):
        def cb(_ref):
            with self.lock:
                self.live_bytes -= self.live.pop(key, 0)
        return cb

    def _track(self, out):
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or _is_dtensor(t):
                continue
            st, key = _storage_key(t)
            with self.lock:
                if key in self.args_keys or key in self.live:
                    continue
                n = st.nbytes()
                self.live[key] = n
                self.live_bytes += n
                self.peak = max(self.peak, self.live_bytes)
            self.refs.append(weakref.ref(st, self._freed(key)))

    def _collective(self, func, args, out) -> bool:
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            kind, nbytes = _FUNCOL.get(name), _nbytes(out)
        elif ns == "c10d":
            kind, nbytes = _C10D.get(name), _nbytes(args[0] if args else [])
        else:
            return False
        if kind is not None:
            mult = 2.0 if kind == "all-reduce" else 1.0
            with self.lock:
                self.stats.collective_bytes[kind] += nbytes * mult
                self.stats.collective_counts[kind] += 1
        elif name not in _NO_TRAFFIC and not name.startswith("wait"):
            with self.lock:
                if len(self.stats.warnings) < 100:
                    self.stats.warnings.append(
                        f"collective {ns}.{name} is none of the five kinds")
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_QUIET, "depth", 0):
            return func(*args, **kwargs)
        if any(_is_dtensor(a) for a in tree_leaves((args, kwargs))):
            return NotImplemented        # DTensor runs it on local shards
        out = func(*args, **kwargs)
        if self._collective(func, args, out):
            return out
        self._track(out)
        name = func._schema.name.split("::")[-1]
        packet = func._overloadpacket
        if packet in self.flop_registry:
            flops = self.flop_registry[packet](*args, **kwargs, out_val=out)
            with self.lock:
                self.stats.flops += flops
        if (func.namespace == "aten" and not func.is_view
                and name not in _NO_TRAFFIC):
            moved = (sum(_nbytes(a) for a in tree_leaves((args, kwargs))
                         if isinstance(a, torch.Tensor)) + _nbytes(
                tree_leaves(out)))
            with self.lock:
                self.stats.hbm_bytes += moved
        return out


def _storages(tree) -> dict:
    """The unique storages of a tree's tensors (DTensors by their local
    shard): key -> bytes."""
    out = {}
    for t in tree_leaves(tree):
        t = _local(t)
        if isinstance(t, torch.Tensor):
            st, key = _storage_key(t)
            out[key] = st.nbytes()
    return out


def analyze_step(fn, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once under the counting mode and return
    its per-device :class:`OpStats` (``memory`` included).  The result of
    ``fn`` is dropped once its storages are measured."""
    stats = OpStats()
    arg_st = _storages((args, kwargs))
    mode = _Counter(stats, set(arg_st))
    with _dtensor_bookkeeping() as warning, mode:
        if warning:
            stats.warnings.append(warning)
        result = fn(*args, **kwargs)
    out_st = _storages(result)
    stats.memory = {
        "argument_bytes": int(sum(arg_st.values())),
        "output_bytes": int(sum(out_st.values())),
        "temp_bytes": int(mode.peak),
        "alias_bytes": int(sum(n for k, n in out_st.items() if k in arg_st)),
    }
    del result
    stats.flops = float(stats.flops)
    stats.hbm_bytes = float(stats.hbm_bytes)
    if not math.isfinite(stats.flops):
        stats.warnings.append("non-finite FLOP count")
    return stats
