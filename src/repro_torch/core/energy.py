"""Energy-harvesting model: sources, storage, prediction (paper §2, §4.1).

PyTorch counterpart of :mod:`repro.core.energy`: the Table-2 cost ladder,
the supercapacitor updates and the moving-average harvest predictor are the
same float32 arithmetic in the same order, so a port run and a JAX run of
the same slot agree to the last bit where the operations allow it.

Harvest and alive traces are drawn from an explicit ``torch.Generator``
instead of a ``jax.random`` key.  They match the JAX traces in
distribution, not value for value; parity tests hand both packages the
same numpy trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "EnergyCosts", "TABLE2_COSTS", "BEARING_COST_SCALE", "D5_RAW",
    "harvest_trace", "EH_SOURCES",
    "fleet_source_assignment", "fleet_harvest_traces", "fleet_phase_offsets",
    "fleet_alive_traces", "supercap_step", "supercap_step_direct",
    "SUPERCAP_CAP_UJ", "SUPERCAP_CHARGE_EFF", "BrownoutConfig",
    "PredictorState", "predictor_init", "predictor_update",
    "predictor_forecast",
]

# Table 2's sixth row is the raw-transmission baseline, not a decision code:
# decision code 5 is DEFER (sensing only).
D5_RAW = 5


@dataclasses.dataclass(frozen=True)
class EnergyCosts:
    """µJ per action — paper Table 2 (sensor column + comm column).  Field
    meanings as in :class:`repro.core.energy.EnergyCosts`."""

    sense: float = 0.54
    dnn_full: float = 29.23
    dnn16: float = 16.58
    dnn12: float = 9.95
    coreset_cluster: float = 1.07
    coreset_sampling: float = 0.87
    tx_result: float = 8.27
    tx_coreset: float = 15.97
    tx_raw: float = 70.16
    aux_head: float = 0.41
    stage_split: tuple[float, float, float] = (0.0626, 0.6672, 0.2702)

    def __post_init__(self):
        if len(self.stage_split) != 3 or min(self.stage_split) <= 0.0:
            raise ValueError(
                f"stage_split must be 3 positive per-stage fractions, got "
                f"{self.stage_split}")

    def decision_costs(self) -> tuple[float, ...]:
        """(9,) µJ per decision code D0..D4 + DEFER + D6/D7/D8 — the single
        cost table the ladder and the Table-2 totals derive from."""
        return (
            self.sense + self.tx_result,                        # D0 memoize
            self.dnn_full + self.tx_result,                     # D1 full DNN
            self.dnn16 + self.tx_result,                        # D2 quantized
            self.sense + self.coreset_cluster + self.tx_coreset,   # D3
            self.sense + self.coreset_sampling + self.tx_coreset,  # D4
            self.sense,                                         # DEFER
            self.sense,                                         # D6 partial
            self.sense + self.aux_head + self.tx_result,        # D7 early exit
            self.sense + self.tx_result,                        # D8 staged full
        )

    def stage_costs(self, quant_bits: int = 16) -> tuple[float, float, float]:
        """(3,) µJ per staged-inference stage, summing to the quantized-DNN
        energy at ``quant_bits``."""
        base = {16: self.dnn16, 12: self.dnn12}.get(quant_bits, self.dnn16)
        tot = sum(self.stage_split)
        return tuple(base * f / tot for f in self.stage_split)

    def total(self, row: int) -> float:
        """Paper Table 2 row totals: 0..4 = D0..D4, :data:`D5_RAW` = raw."""
        return (self.decision_costs()[:5] + (self.tx_raw,))[row]


TABLE2_COSTS = EnergyCosts()

# The task lane's ladder scale for bearing-vibration monitors: their
# kHz-rate front end costs more per slot than a 50 Hz IMU's, and 1.5x is
# the ratio of the bearing window's MAC count to HAR's on the shared (T, C)
# grid.  One scalar on the whole ladder keeps its structure, only shifted.
BEARING_COST_SCALE = 1.5

# ---------------------------------------------------------------------------
# Harvest traces (µJ per slot); one slot is one 0.6 s sensing window.
# ---------------------------------------------------------------------------

SLOT_SECONDS = 0.6
EH_SOURCES = ("rf", "wifi", "piezo", "solar")


def _bursty(gen: torch.Generator, rows: int, n: int, mean_power_uw: float,
            burstiness: float, period: float) -> torch.Tensor:
    """Log-normal modulated sinusoid: fickle income with occasional
    droughts.  (rows, n) µJ."""
    dev = gen.device
    t = torch.arange(n, device=dev, dtype=torch.float32) * SLOT_SECONDS
    base = 0.5 * (1.0 + torch.sin(2 * math.pi * t / period))
    z = torch.randn((rows, n), generator=gen, device=dev)
    noise = torch.exp(burstiness * z - 0.5 * burstiness ** 2)
    u = torch.rand((rows, n), generator=gen, device=dev)
    dropout = (u > 0.15).to(torch.float32)
    return mean_power_uw * base * noise * dropout * SLOT_SECONDS


def _source_traces(gen: torch.Generator, rows: int, n: int,
                   source: str) -> torch.Tensor:
    dev = gen.device
    if source == "rf":
        return _bursty(gen, rows, n, 45.0, 0.9, 40.0)
    if source == "wifi":
        return _bursty(gen, rows, n, 70.0, 1.2, 15.0)
    if source == "piezo":
        active = (torch.rand((rows, n), generator=gen, device=dev)
                  > 0.35).to(torch.float32)
        jitter = 1.0 + 0.3 * torch.randn((rows, n), generator=gen, device=dev)
        return torch.clamp(250.0 * active * jitter, min=0.0) * SLOT_SECONDS
    if source == "solar":
        t = torch.arange(n, device=dev, dtype=torch.float32) * SLOT_SECONDS
        diurnal = torch.clamp(torch.sin(2 * math.pi * t / (n * SLOT_SECONDS)),
                              min=0.0)
        clouds = 0.6 + 0.4 * torch.rand((rows, n), generator=gen, device=dev)
        return 800.0 * diurnal * clouds * SLOT_SECONDS
    raise ValueError(f"unknown EH source {source!r}; options: {EH_SOURCES}")


def harvest_trace(generator: torch.Generator, n: int,
                  source: str = "rf") -> torch.Tensor:
    """µJ harvested in each of ``n`` slots for a named source modality,
    on the generator's device."""
    return _source_traces(generator, 1, n, source)[0]


def fleet_source_assignment(n_nodes: int, sources=EH_SOURCES) -> np.ndarray:
    """Node -> harvest-modality index: round-robin over ``sources``."""
    return np.arange(n_nodes) % len(tuple(sources))


def fleet_harvest_traces(generator: torch.Generator, n_nodes: int,
                         n_slots: int, sources=EH_SOURCES) -> torch.Tensor:
    """(N, S) heterogeneous per-node harvest: node ``i`` draws the modality
    :func:`fleet_source_assignment` gives it, every node its own draws."""
    sources = tuple(sources)
    out = torch.zeros((n_nodes, n_slots), dtype=torch.float32,
                      device=generator.device)
    node_src = fleet_source_assignment(n_nodes, sources)
    for si, src in enumerate(sources):
        sel = np.nonzero(node_src == si)[0]
        if sel.size == 0:
            continue
        idx = torch.as_tensor(sel, device=generator.device)
        out[idx] = _source_traces(generator, sel.size, n_slots, src)
    return out


# ---------------------------------------------------------------------------
# Node churn: dropout/rejoin alive traces
# ---------------------------------------------------------------------------

def fleet_phase_offsets(generator: torch.Generator, n_nodes: int,
                        period: int = 16) -> torch.Tensor:
    """(N,) int32 per-node activity phase offsets in ``[0, period)``."""
    return torch.randint(0, period, (n_nodes,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def fleet_alive_traces(generator: torch.Generator, n_nodes: int,
                       n_slots: int, *, duty: float = 0.75, period: int = 16,
                       p_glitch: float = 0.05) -> torch.Tensor:
    """(N, S) bool per-node dropout/rejoin process: node ``i`` is up while
    its phase-offset duty cycle says so (``(t + phase_i) % period <
    duty * period``) and it does not glitch (an independent per-slot
    brown-out with probability ``p_glitch``).  ``duty=1.0, p_glitch=0.0``
    gives the all-True trace."""
    if not 0.0 <= duty <= 1.0:
        raise ValueError(f"duty must be in [0, 1], got {duty}")
    dev = generator.device
    phases = fleet_phase_offsets(generator, n_nodes, period)
    t = torch.arange(n_slots, dtype=torch.int32, device=dev)
    on = (t[None, :] + phases[:, None]) % period < duty * period
    glitch = torch.rand((n_nodes, n_slots), generator=generator,
                        device=dev) < p_glitch
    return on & ~glitch


# ---------------------------------------------------------------------------
# Supercap storage
# ---------------------------------------------------------------------------

SUPERCAP_CAP_UJ = 200.0
SUPERCAP_CHARGE_EFF = 0.8


def supercap_step(stored_uj: torch.Tensor, harvested_uj: torch.Tensor,
                  spent_uj: torch.Tensor, cap_uj: float = SUPERCAP_CAP_UJ,
                  charge_eff: float = SUPERCAP_CHARGE_EFF) -> torch.Tensor:
    """One storage update: lossy charging, hard capacity, floor at 0 (the
    floor forgives debt; see :func:`supercap_step_direct`)."""
    return torch.clamp(stored_uj + charge_eff * harvested_uj - spent_uj,
                       0.0, cap_uj)


def supercap_step_direct(stored_uj: torch.Tensor, harvested_uj: torch.Tensor,
                         spent_uj: torch.Tensor,
                         cap_uj: float = SUPERCAP_CAP_UJ,
                         charge_eff: float = SUPERCAP_CHARGE_EFF
                         ) -> torch.Tensor:
    """Store-and-execute update: energy spent in the slot it was harvested
    bypasses the charging loss, any deficit draws on ``stored``."""
    direct = torch.minimum(spent_uj, harvested_uj)
    return torch.clamp(stored_uj + charge_eff * (harvested_uj - direct)
                       - (spent_uj - direct), 0.0, cap_uj)


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Supercapacitor brown-out hysteresis (µJ): a running node whose
    post-slot charge falls below ``off_uj`` powers down (its carry freezes,
    the harvester keeps trickle-charging) and reboots once the charge is
    back to ``restart_uj``."""

    off_uj: float = 5.0
    restart_uj: float = 25.0

    def __post_init__(self):
        if not 0.0 <= self.off_uj <= self.restart_uj:
            raise ValueError(
                f"BrownoutConfig needs 0 <= off_uj <= restart_uj, got "
                f"off_uj={self.off_uj}, restart_uj={self.restart_uj}")


# ---------------------------------------------------------------------------
# Moving-average power predictor (paper Fig. 8 step 2a)
# ---------------------------------------------------------------------------

class PredictorState(NamedTuple):
    history: torch.Tensor   # (W,) or (N, W) ring buffer of recent harvest
    pos: torch.Tensor       # () or (N,) int32 write cursor


def predictor_init(window: int = 8, batch: int | None = None,
                   device=None) -> PredictorState:
    """Scalar-node state by default; ``batch=N`` builds the stacked state
    the fleet engine carries from slot to slot."""
    lead = () if batch is None else (batch,)
    return PredictorState(
        history=torch.zeros(lead + (window,), dtype=torch.float32,
                            device=device),
        pos=torch.zeros(lead, dtype=torch.int32, device=device))


def predictor_update(state: PredictorState,
                     harvested_uj: torch.Tensor) -> PredictorState:
    """Ring-buffer write; works on scalar (W,) and batched (N, W) states."""
    w = state.history.shape[-1]
    slot = (state.pos % w).long()
    if state.history.ndim == 1:
        history = state.history.index_put((slot,), harvested_uj)
    else:
        rows = torch.arange(state.history.shape[0],
                            device=state.history.device)
        history = state.history.index_put((rows, slot), harvested_uj)
    return PredictorState(history=history, pos=state.pos + 1)


def predictor_forecast(state: PredictorState,
                       horizon_slots: int = 1) -> torch.Tensor:
    """Expected µJ income over the next ``horizon_slots`` slots."""
    w = state.history.shape[-1]
    filled = torch.clamp(state.pos, max=w).to(torch.float32)
    mean = state.history.sum(dim=-1) / torch.clamp(filled, min=1.0)
    return mean * horizon_slots
