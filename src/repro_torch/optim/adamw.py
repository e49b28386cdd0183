"""AdamW with a selectable moment dtype.

PyTorch counterpart of :mod:`repro.optim.adamw`: the same update in float32,
leaf by leaf over the state tree.  Weight decay applies to the leaves of
two or more dimensions of the *stacked* tree (``convert.lm_params``'
layout), so the stacked norm scales ``(layers, d)`` decay and
``final_norm`` does not, as in the reference.  The moments inherit each
parameter's logical spec (:func:`opt_state_specs`), so on a placed state
they are DTensors on the parameter's placements and the update runs shard
by shard.
"""
from __future__ import annotations

import dataclasses

import torch

from ..sharding import is_dtensor, is_spec
from ..tree import leaves, tree_map, unflatten_like

__all__ = ["OptConfig", "adamw_init", "adamw_update", "opt_state_specs",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params, cfg: OptConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter (on a
    DTensor parameter's placements), and an int32 step of 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=cfg.moment_dtype)

    step_device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def opt_state_specs(param_spec_tree) -> dict:
    """Logical specs of the optimizer state: the moments mirror the
    parameters, the step is a scalar (``()``)."""
    def copy(t):
        if is_spec(t):
            return t
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        return [copy(v) for v in t]

    return {"m": copy(param_spec_tree), "v": copy(param_spec_tree),
            "step": ()}


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of all leaves, summed leaf by leaf in
    ``jax.tree_util``'s order.  A DTensor leaf's sum of squares is that of
    the whole leaf (its shards' sums reduced) before it joins the total,
    so the total is plain and the order is the tree's."""
    total = 0
    for leaf in leaves(tree):
        part = torch.sum(torch.square(leaf.float()))
        if is_dtensor(part):
            part = part.full_tensor()
        total = total + part
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state: dict, cfg: OptConfig,
                 lr: torch.Tensor):
    """One AdamW step.  Returns (new_params, new_opt_state, grad_norm)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:     # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.float()
        return ((p.float() - lr * delta).to(p.dtype),
                m32.to(cfg.moment_dtype), v32.to(cfg.moment_dtype))

    new = [upd(*x) for x in zip(leaves(params), leaves(grads),
                                leaves(opt_state["m"]),
                                leaves(opt_state["v"]))]
    new_p, new_m, new_v = (unflatten_like(params, [t[i] for t in new])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
