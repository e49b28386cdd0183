"""Mixture-of-Experts FFN: GShard-style top-k dispatch with capacity.

PyTorch counterpart of :mod:`repro.models.moe`.  Tokens are split into
groups of ``group_size``; within each group every token's top-k experts
get a slot up to ``capacity = ceil(group_size * top_k * capacity_factor /
n_experts)``, in the flattened (token, k) order; over-capacity assignments
contribute nothing (token dropping, as in GShard/Switch).  The experts run
on the (groups, experts, capacity, d) buffer as in the reference; the
one-hot dispatch and combine products are an index scatter and gather here
(a product with an exact 0 or 1 changes no value).

DeepSeekMoE's shared experts are a plain dense FFN of width
``n_shared * d_expert`` added unconditionally.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import MoEConfig
from ..sharding import constrain

__all__ = ["MoERoute", "moe_capacity", "moe_param_shapes", "moe_route",
           "moe_apply"]


class MoERoute(NamedTuple):
    """One group-local routing, each (g, s, k): the renormalised top-k
    probabilities (float32), the experts, each assignment's position in
    its expert's queue, and whether it is within the capacity."""
    top_p: torch.Tensor
    top_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def moe_capacity(m: MoEConfig, group_size: int) -> int:
    cap = int(math.ceil(group_size * m.top_k * m.capacity_factor
                        / m.n_experts))
    return max(cap, 1)


def moe_param_shapes(d_model: int, m: MoEConfig) -> dict[str, tuple]:
    """name -> (shape, logical spec), in the reference's order."""
    e, f = m.n_experts, m.d_expert
    shapes = {
        "router": ((d_model, e), ("embed", "experts")),
        "w_gate": ((e, d_model, f), ("experts", "embed", "expert_ff")),
        "w_up": ((e, d_model, f), ("experts", "embed", "expert_ff")),
        "w_down": ((e, f, d_model), ("experts", "expert_ff", "embed")),
    }
    if m.n_shared:
        ds = m.n_shared * f
        shapes.update({"shared_gate": ((d_model, ds), ("embed", "ff")),
                       "shared_up": ((d_model, ds), ("embed", "ff")),
                       "shared_down": ((ds, d_model), ("ff", "embed"))})
    return shapes


def _group(m: MoEConfig, tokens: int) -> int:
    group = min(m.group_size, tokens)
    if tokens % group:
        raise ValueError(
            f"MoE dispatch needs batch x sequence ({tokens} tokens) to be a "
            f"multiple of min(group_size, tokens) = {group}")
    return group


def moe_route(router: torch.Tensor, xt: torch.Tensor,
              m: MoEConfig) -> MoERoute:
    """Route the groups ``xt`` (g, s, d): router logits in ``xt``'s dtype,
    softmax in float32, the top-k experts (lowest index first on ties, as
    ``jax.lax.top_k``), their probabilities renormalised before any drop,
    and each assignment's queue position in the token-major, k-inner
    order."""
    g, s, _ = xt.shape
    logits = torch.einsum("gsd,de->gse", xt, router.to(xt.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :m.top_k], top_e[..., :m.top_k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    # position of each (token, k) within its expert's queue, group-local
    flat = F.one_hot(top_e.reshape(g, s * m.top_k), m.n_experts)
    before = torch.cumsum(flat, dim=1) - flat
    pos = before.gather(-1, top_e.reshape(g, s * m.top_k, 1)).reshape(
        g, s, m.top_k)
    return MoERoute(top_p, top_e, pos, pos < moe_capacity(m, s))


def moe_apply(params: dict, x: torch.Tensor, m: MoEConfig,
              act) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  ``act``: the gate activation (swiglu or
    geglu).  Raises ``ValueError`` when B*S is no multiple of the group."""
    b, s, d = x.shape
    dt = x.dtype
    group = _group(m, b * s)
    g, e = b * s // group, m.n_experts
    cap = moe_capacity(m, group)
    xt = x.reshape(g, group, d)
    route = moe_route(params["router"], xt, m)

    # dispatch: each kept assignment's token into its (expert, slot) row of
    # the capacity buffer; dropped ones into a spare row, then cut off
    slot = route.top_e * cap + route.pos
    rows = torch.where(route.keep, slot, e * cap)
    rows = rows + torch.arange(g, device=x.device)[:, None, None] * (
        e * cap + 1)
    buf = x.new_zeros((g * (e * cap + 1), d))
    buf[rows.reshape(-1)] = xt[:, :, None].expand(
        g, group, m.top_k, d).reshape(-1, d)
    expert_in = buf.reshape(g, e * cap + 1, d)[:, :-1].reshape(g, e, cap, d)
    expert_in = constrain(expert_in, None, "experts", None, "embed_act")

    gate = torch.einsum("gecd,edf->gecf", expert_in, params["w_gate"].to(dt))
    up = torch.einsum("gecd,edf->gecf", expert_in, params["w_up"].to(dt))
    expert_out = torch.einsum("gecf,efd->gecd", act(gate, up),
                              params["w_down"].to(dt))

    # combine: the kept assignments' outputs weighted by top_p (built in
    # float32, cast to x's dtype before the product)
    weight = torch.where(route.keep, route.top_p, 0.0).to(dt)
    picked = expert_out.reshape(g, e * cap, d).gather(
        1, torch.where(route.keep, slot, 0).reshape(g, -1, 1).expand(-1, -1, d))
    out = torch.einsum("gsk,gskd->gsd", weight,
                       picked.reshape(g, group, m.top_k, d))

    if m.n_shared:
        sg = xt @ params["shared_gate"].to(dt)
        su = xt @ params["shared_up"].to(dt)
        out = out + act(sg, su) @ params["shared_down"].to(dt)
    return out.reshape(b, s, d)
