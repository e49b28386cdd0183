"""Convert the JAX package's parameters and state into the port's.

Each function takes the JAX-side object as it is — a dict of arrays or a
NamedTuple with the same field names — and reads its leaves through
``numpy``, so this module needs neither JAX nor the JAX package.  The
layouts are the same on both sides (HAR conv weights (K, Cin, Cout),
dense weights (in, out)), so conversion is a copy, and both packages then
compute the same thing.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.aac import AACTable
from .core.energy import PredictorState
from .core.recovery import DiscriminatorParams, GeneratorParams
from .host.cache import RecoveryCache
from .host.queue import PayloadQueue
from .host.server import HostPayload, HostServerState
from .serving.edge_host import (IntermittentState, SeekerNodeState,
                                WirePayload, WireSamplePayload)

__all__ = ["tensor", "har_params", "aux_params", "generator_params",
           "discriminator_params", "aac_table", "node_state",
           "intermittent_state", "task_host_params", "telemetry_state",
           "wire_payload", "wire_sample_payload", "host_payload",
           "host_server_state", "lm_params", "train_state", "to_numpy"]


def tensor(x, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """A copy of an array-like (numpy, JAX, list) as a torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def har_params(params, device=None) -> dict[str, torch.Tensor]:
    """``repro.models.har.har_init`` params -> the port's HAR params."""
    return {k: tensor(v, torch.float32, device) for k, v in params.items()}


def aux_params(params, device=None) -> dict[str, torch.Tensor]:
    """``repro.models.har.har_aux_init`` heads -> the port's."""
    return har_params(params, device)


def generator_params(params, device=None) -> GeneratorParams:
    """``repro.core.recovery.GeneratorParams`` -> the port's."""
    return GeneratorParams(*(tensor(getattr(params, f), torch.float32, device)
                             for f in GeneratorParams._fields))


def discriminator_params(params, device=None) -> DiscriminatorParams:
    """``repro.core.recovery.DiscriminatorParams`` -> the port's."""
    return DiscriminatorParams(*(tensor(getattr(params, f), torch.float32,
                                        device)
                                 for f in DiscriminatorParams._fields))


def aac_table(table, device=None) -> AACTable:
    """``repro.core.aac.AACTable`` -> the port's."""
    return AACTable(acc=tensor(table.acc, torch.float32, device),
                    ks=tensor(table.ks, torch.int32, device))


def node_state(state, device=None) -> SeekerNodeState:
    """A (stacked) ``repro.serving.edge_host.SeekerNodeState`` -> the
    port's."""
    return SeekerNodeState(
        stored_uj=tensor(state.stored_uj, torch.float32, device),
        predictor=PredictorState(
            history=tensor(state.predictor.history, torch.float32, device),
            pos=tensor(state.predictor.pos, torch.int32, device)),
        prev_label=tensor(state.prev_label, torch.int32, device))


def intermittent_state(state, device=None) -> IntermittentState:
    """A (stacked) ``repro.serving.edge_host.IntermittentState`` -> the
    port's."""
    return IntermittentState(
        active=tensor(state.active, torch.bool, device),
        stage=tensor(state.stage, torch.int32, device),
        acts=tensor(state.acts, torch.float32, device),
        src_slot=tensor(state.src_slot, torch.int32, device))


def task_host_params(trees, device=None) -> tuple[dict, ...]:
    """A sequence of ``repro.models.har.har_init`` trees, one per task (the
    ``per_task_host`` form of ``host_params``) -> a tuple of the port's."""
    return tuple(har_params(t, device) for t in trees)


def telemetry_state(metrics, device=None) -> dict[str, torch.Tensor]:
    """A JAX engine's ``res["telemetry"]`` dict -> the port's int32
    tensors (a ``telemetry_state0``)."""
    return {k: tensor(v, torch.int32, device) for k, v in metrics.items()}


def _same_dtypes(tup, cls, device):
    """A NamedTuple of arrays -> ``cls`` of tensors with each leaf's dtype
    (int8, int16, int32, bool, float32) kept."""
    return cls(*(torch.as_tensor(np.array(getattr(tup, f)), device=device)
                 for f in cls._fields))


def wire_payload(p, device=None) -> WirePayload:
    """``repro.serving.edge_host.WirePayload`` -> the port's (int16, int8,
    int8 codes and float32 ranges)."""
    return _same_dtypes(p, WirePayload, device)


def wire_sample_payload(p, device=None) -> WireSamplePayload:
    """``repro.serving.edge_host.WireSamplePayload`` -> the port's."""
    return _same_dtypes(p, WireSamplePayload, device)


def host_payload(p, device=None) -> HostPayload:
    """``repro.host.server.HostPayload`` entries -> the port's."""
    return _same_dtypes(p, HostPayload, device)


def host_server_state(state, device=None) -> HostServerState:
    """``repro.host.server.HostServerState`` -> the port's: the same layout,
    with the uint32 cache signatures held as int64."""
    q, c = state.queue, state.cache

    def t(x, dtype=None):
        return tensor(x, dtype, device)

    return HostServerState(
        queue=PayloadQueue(
            payload=host_payload(q.payload, device),
            node_id=t(q.node_id, torch.int32),
            arrival=t(q.arrival, torch.int32),
            deadline=t(q.deadline, torch.int32), valid=t(q.valid, torch.bool),
            cursor=t(q.cursor, torch.int32),
            drops_overflow=t(q.drops_overflow, torch.int32)),
        cache=RecoveryCache(
            sig=t(np.asarray(c.sig).astype(np.int64)),
            logits=t(c.logits, torch.float32), valid=t(c.valid, torch.bool),
            cursor=t(c.cursor, torch.int32), hits=t(c.hits, torch.int32),
            misses=t(c.misses, torch.int32)),
        slot=t(state.slot, torch.int32), served=t(state.served, torch.int32),
        deadline_misses=t(state.deadline_misses, torch.int32),
        ensemble_logits=t(state.ensemble_logits, torch.float32),
        ensemble_votes=t(state.ensemble_votes, torch.int32),
        metrics=(None if state.metrics is None
                 else telemetry_state(state.metrics, device)))


def _leaf(x, device=None) -> torch.Tensor:
    """An array-like as a tensor of its dtype; a bfloat16 array (numpy has
    none of its own: ``ml_dtypes``' two-byte type) through its bits."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.as_tensor(a, device=device)


def _tree(tree, device=None):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, device) for v in tree]
    return _leaf(tree, device)


def lm_params(tree, device=None, shardings=None):
    """``repro.models.init_params``'s LM parameter tree (``embed``,
    ``final_norm``, ``unembed``, ``runs`` of stacked leaves, ``encoder``
    with its own ``runs`` and ``final_norm``) -> the port's tree of the
    same names and layouts, each leaf's dtype kept.  With ``shardings``
    (a ``NamedSharding`` tree, :func:`repro_torch.sharding.
    tree_named_shardings`) each leaf is placed on its mesh as a DTensor,
    every rank keeping its shard."""
    out = _tree(tree, device)
    if shardings is not None:
        from .sharding import place
        out = place(out, shardings)
    return out


def train_state(tree, device=None, shardings=None) -> dict:
    """``repro.train.init_train_state``'s state — ``{"params", "opt": {"m",
    "v", "step"}}`` and, under error feedback, ``"ef"`` — as the port's,
    each leaf's dtype kept (the int32 step a 0-dim tensor), placed by
    ``shardings`` as :func:`lm_params` places."""
    return lm_params(tree, device, shardings)


def to_numpy(tree):
    """The port's NamedTuples, dicts, lists and tensors as numpy arrays, in
    the same structure (``None`` stays ``None``; a bfloat16 tensor comes
    back as float32, which holds it exactly; a DTensor as its whole
    tensor, a collective), for comparing with JAX."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(x) for x in tree]
    from .sharding import is_dtensor
    if is_dtensor(tree):
        tree = tree.full_tensor()
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
