"""Fault-tolerant training loop: checkpoint/restart, preemption simulation,
energy-budget throttling.

PyTorch counterpart of :mod:`repro.train.loop`.  The paper's sensor node
makes progress under a fickle energy budget by store-and-execute with
non-volatile checkpoints; the trainer's analogues:

* **checkpoint/restart** — atomic checkpoints every ``ckpt_every`` steps;
  on a (simulated) preemption the loop restores the latest manifest into
  the initial state's template and replays from there.  The data pipeline
  is a pure function of the step, so the replayed batches are the same.
* **budget throttling** — a harvested-energy trace gates the steps: while
  the stored budget is below the per-step cost the loop *defers* (the
  paper's store cycles).

Metrics reach the host only at log steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..core.energy import harvest_trace

__all__ = ["TrainLoopConfig", "run_training", "PreemptionError"]


class PreemptionError(RuntimeError):
    """Raised by the preemption simulator mid-run."""


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 200
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    # fault injection
    preempt_at: tuple[int, ...] = ()       # steps that raise PreemptionError
    max_restarts: int = 10
    # energy-budget throttling (None = always-on power)
    budget_source: str | None = None       # "rf" | "wifi" | "piezo" | "solar"
    budget_cost_uj: float = 20.0           # per-step energy cost
    budget_seed: int = 0


def _budget(loop: TrainLoopConfig, budget_trace) -> np.ndarray | None:
    """The µJ harvested before each step, as float32 on the host: the
    given trace, or ``harvest_trace`` of ``budget_source`` from a CPU
    generator seeded with ``budget_seed``."""
    if budget_trace is None and not loop.budget_source:
        return None
    if budget_trace is None:
        budget_trace = harvest_trace(
            torch.Generator().manual_seed(loop.budget_seed),
            loop.total_steps + 1, loop.budget_source)
    if isinstance(budget_trace, torch.Tensor):
        budget_trace = budget_trace.cpu().numpy()
    return np.asarray(budget_trace, dtype=np.float32)


def _run_once(state, step0: int, train_step: Callable, batch_fn: Callable,
              loop: TrainLoopConfig, log: list, preempted: set, budget):
    stored = 0.0
    step = step0
    while step < loop.total_steps:
        if step in loop.preempt_at and step not in preempted:
            preempted.add(step)
            raise PreemptionError(f"simulated preemption at step {step}")
        if budget is not None:
            stored += budget[step]
            if stored < loop.budget_cost_uj:
                log.append({"step": step, "deferred": True, "stored": stored})
                step += 1
                continue                      # defer: a store cycle
            stored -= loop.budget_cost_uj
        state, metrics = train_step(state, batch_fn(step))
        if step % loop.log_every == 0 or step == loop.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            log.append(m)
        if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            save_checkpoint(loop.ckpt_dir, step + 1, state, keep=loop.keep)
        step += 1
    return state, step


def run_training(state, train_step: Callable, batch_fn: Callable,
                 loop: TrainLoopConfig, budget_trace=None, shardings=None):
    """Run to ``total_steps`` with restart-on-preemption.

    Args:
        state: initial train state tree (ignored when a checkpoint exists;
            the template every restore fills).
        train_step: (state, batch) -> (state, metrics).
        batch_fn: step -> batch (pure function: restart safety).
        loop: loop config.
        budget_trace: the µJ harvested before each step (``total_steps``
            entries at least) in place of ``loop.budget_source``'s trace.
        shardings: a ``NamedSharding`` tree like ``state`` for an elastic
            restore onto a mesh (a placed state's own placements are kept
            without it).  A sharded run is a collective: every rank calls
            it, and checkpoints are written by rank 0.

    Returns (final_state, log: list of metric dicts incl. restart events).
    """
    log: list = []
    preempted: set = set()
    restarts = 0
    template = state
    budget = _budget(loop, budget_trace)
    step0 = 0
    if loop.ckpt_dir:
        s = latest_step(loop.ckpt_dir)
        if s is not None:
            state = restore_checkpoint(loop.ckpt_dir, s, template, shardings)
            step0 = s
            log.append({"event": "resume", "step": s})
    while True:
        try:
            state, _ = _run_once(state, step0, train_step, batch_fn, loop,
                                 log, preempted, budget)
            break
        except PreemptionError as e:
            restarts += 1
            log.append({"event": "preempted", "detail": str(e),
                        "restarts": restarts})
            if restarts > loop.max_restarts:
                raise
            s = latest_step(loop.ckpt_dir) if loop.ckpt_dir else None
            if s is None:
                step0 = 0           # nothing saved yet: restart from scratch
            else:
                state = restore_checkpoint(loop.ckpt_dir, s, template,
                                           shardings)
                step0 = s
                log.append({"event": "resume", "step": s})
    if loop.ckpt_dir:
        save_checkpoint(loop.ckpt_dir, loop.total_steps, state, keep=loop.keep)
    return state, log
