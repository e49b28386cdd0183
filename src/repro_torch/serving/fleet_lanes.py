"""The fleet's lane registry: one registration per per-node lane.

PyTorch counterpart of :mod:`repro.serving.fleet_lanes`.  A lane is a
per-node capability of the fleet engine with its own slice of the carry,
its own inputs and outputs, and a declared behaviour in slots where a node
is dead or browned out (its freeze kind).  :func:`repro_torch.serving.fleet.
seeker_fleet_simulate` freezes every ``keep`` lane through the registry, and
refuses the engine arguments of lanes that are not registered yet (the task
and telemetry lanes).

The port has no PRNG-key lane: its noise is injected per slot
(:func:`repro_torch.serving.fleet.draw_slot_noise`), so nothing random is
carried, and a dead node's noise is simply unused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

__all__ = ["FleetCarry", "FleetLane", "FLEET_LANES", "FREEZE_KINDS",
           "fleet_trace_keys"]


class FleetCarry(NamedTuple):
    """What the fleet engine carries from slot to slot, one field per
    carried lane; an absent lane is ``None``."""

    node: Any            # stacked SeekerNodeState, always present
    brownout: Any        # (N,) bool browned-out flag, always present (all
                         # False when the brown-out lane is off)
    intermittent: Any    # stacked IntermittentState | None
    telemetry: Any       # not ported: always None


# what a lane does in a slot where its node is dead or browned out:
#   keep     - its carry stays as it was (the engine's keep() select)
#   trickle  - keep, except the harvester still charges the supercap
#   merge    - a fleet-level accumulator, never frozen per node
#   input    - a per-slot input, not carried state
#   static   - per-node constants
FREEZE_KINDS = ("keep", "trickle", "merge", "input", "static")


@dataclasses.dataclass(frozen=True)
class FleetLane:
    """One lane's registration.

    ``config_kwarg`` is the engine argument whose non-``None`` value turns
    the lane on (``None``: always on); ``carry_field`` its
    :class:`FleetCarry` field; ``resume_in``/``resume_out`` the engine
    arguments and result keys that resume it; ``aggregates`` its result
    counters; ``trace_keys`` its (S, N) result traces; ``counter_keys`` the
    aggregates a chain of runs adds up.  ``outputs_when_off`` lanes emit
    their traces and aggregates (as inert zeros) even when off."""

    name: str
    doc: str
    carry_field: str | None
    config_kwarg: str | None
    init: str
    freeze: str
    resume_in: tuple[str, ...]
    resume_out: tuple[str, ...]
    aggregates: tuple[str, ...]
    trace_keys: tuple[str, ...]
    counter_keys: tuple[str, ...]
    outputs_when_off: bool = False

    def __post_init__(self):
        if self.freeze not in FREEZE_KINDS:
            raise ValueError(f"lane {self.name!r}: freeze must be one of "
                             f"{FREEZE_KINDS}, got {self.freeze!r}")
        if self.carry_field is not None:
            if self.carry_field not in FleetCarry._fields:
                raise ValueError(
                    f"lane {self.name!r}: carry_field {self.carry_field!r} "
                    f"is not a FleetCarry field {FleetCarry._fields}")
            if not self.resume_in or not self.resume_out:
                raise ValueError(f"lane {self.name!r} carries state but "
                                 f"declares no resume contract")

    def active(self, active_names: frozenset) -> bool:
        """Does this lane emit traces and aggregates in this run?"""
        return (self.config_kwarg is None or self.outputs_when_off
                or self.name in active_names)


FLEET_LANES: tuple[FleetLane, ...] = (
    FleetLane(
        name="node",
        doc="Stacked per-node Seeker state: supercap charge, harvest "
            "predictor, AAC label continuity.",
        carry_field="node", config_kwarg=None,
        init="repro_torch.serving.fleet:fleet_node_init", freeze="keep",
        resume_in=("state0",), resume_out=("final_state",),
        aggregates=("bytes_on_wire", "bytes_on_wire_exact",
                    "decision_histogram", "completed", "alive_slots",
                    "correct"),
        trace_keys=("decisions", "payload_bytes", "stored_uj", "k_trace",
                    "logits", "preds"),
        counter_keys=("decision_histogram", "completed", "alive_slots",
                      "correct")),
    FleetLane(
        name="churn",
        doc="Exogenous dropout/rejoin: an (N, S) alive trace input; dead "
            "slots freeze every 'keep' lane and emit DEFER with zero "
            "payload.",
        carry_field=None, config_kwarg="alive",
        init="repro_torch.core.energy:fleet_alive_traces", freeze="input",
        resume_in=(), resume_out=(), aggregates=(), trace_keys=("alive",),
        counter_keys=(), outputs_when_off=True),
    FleetLane(
        name="brownout",
        doc="Endogenous churn: supercap-hysteresis brown-out flag in the "
            "carry; browned-out slots freeze like dead ones but the "
            "harvester keeps trickle-charging.",
        carry_field="brownout", config_kwarg="brownout",
        init="repro_torch.serving.fleet:_resolve_brownout0",
        freeze="trickle", resume_in=("brownout_state0",),
        resume_out=("final_brownout",),
        aggregates=("brownout_slots", "brownout_events"),
        trace_keys=("brownout",),
        counter_keys=("brownout_slots", "brownout_events"),
        outputs_when_off=True),
    FleetLane(
        name="intermittent",
        doc="Staged partial inference: suspended activations ride the carry "
            "across slots and brown-outs; DEFER slots become D6/D7/D8.",
        carry_field="intermittent", config_kwarg="intermittent",
        init="repro_torch.serving.edge_host:intermittent_fleet_init",
        freeze="keep", resume_in=("intermittent_state0", "slot0"),
        resume_out=("final_intermittent",),
        aggregates=("it_full", "it_early", "correct_ladder",
                    "it_correct_full", "it_correct_early"),
        trace_keys=("it_emit", "it_label", "it_conf", "it_src", "it_stage"),
        counter_keys=("it_full", "it_early", "correct_ladder")),
)


def fleet_trace_keys(active: frozenset) -> tuple[str, ...]:
    """The (S, N) result traces of a run with these lanes on, in
    registration order."""
    return tuple(k for ln in FLEET_LANES if ln.active(active)
                 for k in ln.trace_keys)

