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
from .core.recovery import GeneratorParams
from .serving.edge_host import IntermittentState, SeekerNodeState

__all__ = ["tensor", "har_params", "aux_params", "generator_params",
           "aac_table", "node_state", "intermittent_state",
           "task_host_params", "telemetry_state"]


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
