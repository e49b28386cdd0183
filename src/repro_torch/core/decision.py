"""Seeker's energy-aware decision flow (paper §4.1, Fig. 8).

PyTorch counterpart of :mod:`repro.core.decision`.  The selector works
elementwise, so the same call serves one node (0-d tensors) or a whole
fleet (``(N,)`` tensors) — JAX's ``vmap`` over nodes written out.

Codes: D0 memoization hit, D1 full DNN, D2 quantized DNN, D3 cluster
coreset, D4 sampling coreset, DEFER, and the intermittent lane's D6/D7/D8
(emitted by that lane, never by :func:`choose_decision`).
"""
from __future__ import annotations

from typing import NamedTuple

import dataclasses
import functools

import torch

from .energy import EnergyCosts

__all__ = ["D0_MEMO", "D1_DNN_FULL", "D2_DNN_QUANT", "D3_CLUSTER",
           "D4_SAMPLING", "DEFER", "D6_PARTIAL", "D7_EARLY_EXIT",
           "D8_STAGED_FULL", "N_INTERMITTENT_DECISIONS", "IntermittentConfig",
           "DecisionOutcome",
           "choose_decision", "decision_energy"]

D0_MEMO = 0
D1_DNN_FULL = 1
D2_DNN_QUANT = 2
D3_CLUSTER = 3
D4_SAMPLING = 4
DEFER = 5
D6_PARTIAL = 6
D7_EARLY_EXIT = 7
D8_STAGED_FULL = 8

N_INTERMITTENT_DECISIONS = D8_STAGED_FULL + 1   # histogram bins, lane enabled


@dataclasses.dataclass(frozen=True)
class IntermittentConfig:
    """The intermittent-inference lane's knobs.

    ``min_exit_stage``: earliest completed stage (1 or 2) whose auxiliary
    head may emit an early-exit result when the remaining stages are
    unaffordable.  ``exit_threshold``: minimum auxiliary-head confidence
    (max softmax) for an early exit; 0.0 exits whenever affordable, a value
    above 1.0 disables early exit."""

    min_exit_stage: int = 1
    exit_threshold: float = 0.0

    def __post_init__(self):
        if self.min_exit_stage not in (1, 2):
            raise ValueError(
                f"min_exit_stage must be 1 or 2 (the stages with an "
                f"auxiliary head), got {self.min_exit_stage}")
        if not self.exit_threshold >= 0.0:
            raise ValueError(
                f"exit_threshold must be >= 0.0, got {self.exit_threshold}")


class DecisionOutcome(NamedTuple):
    decision: torch.Tensor   # int32 in [0, 5]
    spend: torch.Tensor      # float32 µJ this slot will consume


def decision_energy(costs: EnergyCosts, device=None) -> torch.Tensor:
    """(9,) float32 µJ cost vector indexed by decision code."""
    return torch.tensor(costs.decision_costs(), dtype=torch.float32,
                        device=device)


# never evicted: a captured fleet slot (serving/fleet.py) reads it
@functools.lru_cache(maxsize=None)
def _decision_table(costs: tuple, device: torch.device) -> torch.Tensor:
    """:func:`decision_energy` of the ``costs`` (an
    :meth:`EnergyCosts.decision_costs` tuple) made once per table and
    device, so a slot copies nothing from the host; callers only read
    it."""
    return torch.tensor(costs, dtype=torch.float32, device=device)


def choose_decision(max_corr: torch.Tensor, stored_uj: torch.Tensor,
                    forecast_uj: torch.Tensor, costs: EnergyCosts,
                    corr_threshold: float = 0.95,
                    allow_full_dnn: bool = False,
                    harvested_uj: torch.Tensor | None = None,
                    cost_scale: torch.Tensor | None = None
                    ) -> DecisionOutcome:
    """Fig. 8 walk: memo gate -> local DNN if affordable -> cluster coreset
    -> sampling coreset -> defer.

    ``harvested_uj`` switches on strict store-and-execute accounting: a
    decision must be payable from ``stored + harvested`` alone, the memo
    gate is energy-gated, and DEFER's spend clamps to zero when not even
    sensing is payable.  Without it the legacy forecast-budget walk runs.

    ``cost_scale`` (the task lane's per-node float32 factor, shaped like
    ``budget``) scales the whole ladder per node: the table becomes
    ``cost * cost_scale``, one float32 row per node.  ``None`` leaves the
    table and the arithmetic as they are.
    """
    strict = harvested_uj is not None
    budget = stored_uj + (harvested_uj if strict else forecast_uj)
    cost = _decision_table(costs.decision_costs(), budget.device)
    if cost_scale is not None:
        cost = cost * cost_scale[..., None]                  # (..., 9)

    memo_hit = max_corr >= corr_threshold
    if strict:
        memo_hit = memo_hit & (budget >= cost[..., D0_MEMO])
    can_full = budget >= cost[..., D1_DNN_FULL]
    can_quant = budget >= cost[..., D2_DNN_QUANT]
    can_cluster = budget >= cost[..., D3_CLUSTER]
    can_sample = budget >= cost[..., D4_SAMPLING]

    def code(c):
        return torch.full_like(budget, c, dtype=torch.int32)

    if allow_full_dnn:
        dnn_choice = torch.where(can_full, code(D1_DNN_FULL),
                                 code(D2_DNN_QUANT))
        can_dnn = can_full | can_quant
    else:
        dnn_choice = code(D2_DNN_QUANT)
        can_dnn = can_quant
    # prefer clustering over sampling when affordable
    offload = torch.where(can_cluster, code(D3_CLUSTER),
                          torch.where(can_sample, code(D4_SAMPLING),
                                      code(DEFER)))
    local = torch.where(can_dnn, dnn_choice, offload)
    decision = torch.where(memo_hit, code(D0_MEMO), local)
    if cost_scale is None:
        spend = cost[decision.long()]
    else:
        spend = torch.gather(cost, -1, decision.long()[..., None])[..., 0]
    if strict:
        spend = torch.where(budget >= spend, spend, torch.zeros_like(spend))
    return DecisionOutcome(decision=decision, spend=spend)
