"""The fleet's lane registry: one registration per per-node lane.

PyTorch counterpart of :mod:`repro.serving.fleet_lanes`.  A lane is a
per-node capability of the fleet engine with its own slice of the carry,
its own inputs and outputs, and a declared behaviour in slots where a node
is dead or browned out (its freeze kind).
:func:`repro_torch.serving.fleet.seeker_fleet_simulate` freezes every
``keep`` lane through the registry; the streamed driver takes the traces it
concatenates and the counters it sums from it; and the telemetry spec is
the union of the registry lanes each lane owns, advanced each slot by the
lanes' ``telemetry_update``.

The heterogeneous-task lane (:class:`TaskLaneConfig`) gives every node a
task identity (HAR wearables and bearing-vibration monitors in one fleet):
a per-task scale on the whole energy ladder, optional per-task host
weights, and per-task splits of the completion and accuracy counts.

The PRNG-key lane carries per-node noise keys only when a run is given
``node_keys`` (:func:`repro_torch.serving.fleet.fleet_node_keys`); the
generator and ``noise=`` sources inject each slot's noise and carry
nothing, and a dead node's noise is then simply unused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..core.decision import D6_PARTIAL, DEFER, N_INTERMITTENT_DECISIONS
from ..core.energy import BEARING_COST_SCALE
from ..obs import (Lane, counter, counter_add, gauge, gauge_set,
                   hist_observe, histogram)

__all__ = ["FleetCarry", "FleetLane", "FLEET_LANES", "FREEZE_KINDS",
           "TaskLaneConfig", "fleet_lane", "fleet_telemetry_lanes",
           "fleet_trace_keys", "fleet_counter_keys", "fleet_task_assignment",
           "stack_task_params"]

N_DECISIONS = DEFER + 1   # D0..D4 + DEFER: bins of the ladder histogram


class FleetCarry(NamedTuple):
    """What the fleet engine carries from slot to slot, one field per
    carried lane; an absent lane is ``None``."""

    node: Any            # stacked SeekerNodeState, always present
    keys: Any            # (N, 2) per-node noise keys | None
    brownout: Any        # (N,) bool browned-out flag, always present (all
                         # False when the brown-out lane is off)
    intermittent: Any    # stacked IntermittentState | None
    telemetry: Any       # {registry lane name: int32 tensor} | None


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
    aggregates a chain of runs adds up; ``telemetry`` the registry lanes it
    owns (a function of the active-lane set) and ``telemetry_update`` how
    one slot of the engine's masked trace advances them.
    ``outputs_when_off`` lanes emit their traces, aggregates and telemetry
    (as inert zeros) even when off."""

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
    telemetry: Callable[[frozenset], tuple[Lane, ...]] | None = None
    telemetry_update: Callable[..., dict] | None = None
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


@dataclasses.dataclass(frozen=True)
class TaskLaneConfig:
    """Heterogeneous fleets: a task identity per node.

    A mixed fleet gives every node a task id (``tasks`` (N,) int32: HAR
    wearables and bearing-vibration monitors in one deployment).
    ``cost_scale`` scales the whole cost ladder, and the intermittent lane's
    stage costs, per task: a bearing monitor's kHz vibration front end pays
    more per window than a 50 Hz IMU, by :data:`repro_torch.core.energy.
    BEARING_COST_SCALE` by default.

    ``per_task_host`` gives each task its own host weights: ``host_params``
    is then a sequence of ``n_tasks`` trees, and node ``i`` infers through
    tree ``tasks[i]``.  Every task runs one window shape: a mixed fleet
    resamples bearing streams to the HAR (T, C) grid
    (:func:`repro_torch.data.sensors.bearing_stream` with ``t=60``, tiled
    to 3 channels).

    Frozen and hashable, like ``BrownoutConfig`` and
    ``IntermittentConfig``."""

    names: tuple[str, ...] = ("har", "bearing")
    cost_scale: tuple[float, ...] = (1.0, BEARING_COST_SCALE)
    per_task_host: bool = False

    def __post_init__(self):
        if len(self.names) < 1:
            raise ValueError("TaskLaneConfig needs at least one task")
        if len(self.cost_scale) != len(self.names):
            raise ValueError(
                f"TaskLaneConfig: {len(self.names)} task names but "
                f"{len(self.cost_scale)} cost scales")
        if any(not sc > 0.0 for sc in self.cost_scale):
            raise ValueError(
                f"TaskLaneConfig.cost_scale must be > 0, got "
                f"{self.cost_scale}")

    @property
    def n_tasks(self) -> int:
        return len(self.names)


def fleet_task_assignment(n_nodes: int, n_tasks: int = 2,
                          device=None) -> torch.Tensor:
    """Round-robin (N,) int32 task ids, the default mixed-fleet layout
    (task populations within one node of equal, interleaved)."""
    return torch.arange(n_nodes, dtype=torch.int32, device=device) % n_tasks


def stack_task_params(params_by_task) -> Any:
    """Stack per-task parameter trees (dicts, NamedTuples) leaf by leaf on
    a leading task axis."""
    first = params_by_task[0]
    if isinstance(first, dict):
        return {k: stack_task_params([p[k] for p in params_by_task])
                for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_task_params(list(leaves))
                             for leaves in zip(*params_by_task)))
    return torch.stack([torch.as_tensor(p) for p in params_by_task])


# ---------------------------------------------------------------------------
# Telemetry ownership: each lane declares the registry lanes it owns and how
# one slot of the engine's masked trace advances them.  A lane's counters go
# through ``_add``: lane by lane when ``counters`` is None, or collected into
# ``counters`` for one stacked reduction (``repro_torch.obs.counters_add``),
# which gives the same pairs bit for bit.
# ---------------------------------------------------------------------------

def _add(spec, metrics, name, values, mask=None, counters=None):
    if counters is None:
        return counter_add(spec, metrics, name, values, mask)
    counters.append((name, values, mask))
    return metrics


def _completed(decisions: torch.Tensor, alive: torch.Tensor,
               intermittent: bool) -> torch.Tensor:
    """Completed means a result went on the wire: alive, not DEFER and,
    with the intermittent lane, not a D6 suspension."""
    sent = (decisions != DEFER) & alive
    if intermittent:
        sent = sent & (decisions != D6_PARTIAL)
    return sent


def _sent_mask(out_trace: dict, active: frozenset) -> torch.Tensor:
    return _completed(out_trace["decisions"], out_trace["alive"],
                      "intermittent" in active)


def _node_telemetry(active: frozenset) -> tuple[Lane, ...]:
    n_bins = (N_INTERMITTENT_DECISIONS if "intermittent" in active
              else N_DECISIONS)
    return (counter("fleet.wire_bytes", "B"),
            counter("fleet.completed", "windows"),
            counter("fleet.alive_slots", "slots"),
            gauge("fleet.stored_uj", "uJ"),
            histogram("fleet.decisions", n_bins, log=False,
                      unit="decisions"))


def _node_telemetry_update(spec, metrics, out_trace, *, exo_alive_t, active,
                           tasks=None, counters=None):
    act = out_trace["alive"]
    m = _add(spec, metrics, "fleet.wire_bytes", out_trace["payload_bytes"],
             act, counters)
    m = _add(spec, m, "fleet.completed", _sent_mask(out_trace, active),
             None, counters)
    m = _add(spec, m, "fleet.alive_slots", act, None, counters)
    stored = torch.floor(out_trace["stored_uj"]).to(torch.int32)
    m = gauge_set(spec, m, "fleet.stored_uj",
                  torch.sum(torch.where(act, stored, 0)))
    return hist_observe(spec, m, "fleet.decisions", out_trace["decisions"],
                        act)


def _brownout_telemetry(active: frozenset) -> tuple[Lane, ...]:
    return (counter("fleet.brownout_slots", "slots"),
            counter("fleet.brownout_events", "events"))


def _brownout_telemetry_update(spec, metrics, out_trace, *, exo_alive_t,
                               active, tasks=None, counters=None):
    m = _add(spec, metrics, "fleet.brownout_slots",
             out_trace["brownout"] & exo_alive_t, None, counters)
    return _add(spec, m, "fleet.brownout_events", out_trace["bo_event"],
                None, counters)


def _intermittent_telemetry(active: frozenset) -> tuple[Lane, ...]:
    return (counter("fleet.it_full", "windows"),
            counter("fleet.it_early", "windows"))


def _intermittent_telemetry_update(spec, metrics, out_trace, *, exo_alive_t,
                                   active, tasks=None, counters=None):
    act = out_trace["alive"]
    emit = out_trace["it_emit"]
    m = _add(spec, metrics, "fleet.it_full", (emit == 2) & act, None,
             counters)
    return _add(spec, m, "fleet.it_early", (emit == 1) & act, None, counters)


def _task_telemetry(active: frozenset) -> tuple[Lane, ...]:
    # per-task completions as a categorical histogram over task ids; the
    # bin count rides the active-set tag "task:K"
    for tag in active:
        if tag.startswith("task:"):
            n_tasks = int(tag.split(":", 1)[1])
            return (histogram("fleet.task_completed", max(n_tasks, 2),
                              log=False, unit="windows"),)
    return ()


def _task_telemetry_update(spec, metrics, out_trace, *, exo_alive_t, active,
                           tasks=None, counters=None):
    sent = _sent_mask(out_trace, active)
    return hist_observe(spec, metrics, "fleet.task_completed",
                        tasks.expand(sent.shape), sent)


# ---------------------------------------------------------------------------
# The registry, in the JAX package's order.
# ---------------------------------------------------------------------------

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
                      "correct"),
        telemetry=_node_telemetry, telemetry_update=_node_telemetry_update),
    FleetLane(
        name="prng",
        doc="Per-node noise keys: node i's stream is hashed from (seed, i), "
            "advanced each slot the node runs; a fleet of N nodes is "
            "bit-compatible with N one-node runs and any shard layout.",
        carry_field="keys", config_kwarg="node_keys",
        init="repro_torch.serving.fleet:fleet_node_keys", freeze="keep",
        resume_in=("node_keys",), resume_out=("final_keys",),
        aggregates=(), trace_keys=(), counter_keys=()),
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
        telemetry=_brownout_telemetry,
        telemetry_update=_brownout_telemetry_update,
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
        counter_keys=("it_full", "it_early", "correct_ladder"),
        telemetry=_intermittent_telemetry,
        telemetry_update=_intermittent_telemetry_update),
    FleetLane(
        name="telemetry",
        doc="Registry metrics lanes riding the carry; a fleet-level "
            "accumulator merged across segments, never frozen per node.",
        carry_field="telemetry", config_kwarg="telemetry",
        init="repro_torch.obs:metrics_init", freeze="merge",
        resume_in=("telemetry_state0",), resume_out=("telemetry",),
        aggregates=(), trace_keys=(), counter_keys=()),
    FleetLane(
        name="task",
        doc="Heterogeneous multi-workload fleets: static per-node task ids "
            "switch energy-cost scale, host weights and the per-task "
            "aggregate splits.",
        carry_field=None, config_kwarg="task",
        init="repro_torch.serving.fleet_lanes:fleet_task_assignment",
        freeze="static", resume_in=(), resume_out=(),
        aggregates=("completed_by_task", "deadline_miss_by_task",
                    "correct_by_task"),
        trace_keys=(), counter_keys=("completed_by_task",
                                     "deadline_miss_by_task"),
        telemetry=_task_telemetry, telemetry_update=_task_telemetry_update),
)


def fleet_lane(name: str) -> FleetLane:
    """One lane by name (KeyError naming the registered set otherwise)."""
    for ln in FLEET_LANES:
        if ln.name == name:
            return ln
    raise KeyError(f"no fleet lane {name!r}; registered: "
                   f"{[ln.name for ln in FLEET_LANES]}")


def fleet_telemetry_lanes(active: frozenset) -> tuple[Lane, ...]:
    """The telemetry lanes every active (or always-emitting) lane owns, in
    registration order."""
    return tuple(tl for ln in FLEET_LANES
                 if ln.telemetry is not None and ln.active(active)
                 for tl in ln.telemetry(active))


def fleet_trace_keys(active: frozenset) -> tuple[str, ...]:
    """The (S, N) result traces of a run with these lanes on, in
    registration order."""
    return tuple(k for ln in FLEET_LANES if ln.active(active)
                 for k in ln.trace_keys)



def fleet_counter_keys(active: frozenset) -> tuple[str, ...]:
    """The integer aggregates a chain of runs adds up, in registration
    order."""
    return tuple(k for ln in FLEET_LANES if ln.active(active)
                 for k in ln.counter_keys)
