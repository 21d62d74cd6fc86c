"""Fault tolerance & elasticity for 1000+-node runs: the reference
package's ``repro.train.fault_tolerance``, numpy only, copied into the
port.

Components (exercised by tests/test_torch_train.py):

* ``HeartbeatMonitor`` — per-worker step-time tracking; flags stragglers
  (step time > straggler_factor x rolling median) and dead workers
  (missed heartbeats). On a GPU cluster the equivalent signal comes from
  the job's coordination service; the policy layer is identical.

* ``ElasticPlan`` — given the surviving device count, re-solve the mesh
  (largest (data, model) grid that divides the survivors, preferring to
  keep `model` intact since TP re-sharding moves the most weight bytes)
  and re-shard from the last checkpoint. DistSim itself
  (repro_torch.core) is used to pick the best strategy for the NEW world
  size — the paper's §6 use-case applied to failure recovery.

* ``run_with_recovery`` — the outer loop: on simulated failure, restores
  the latest checkpoint, rebuilds the mesh, continues. Guarantees
  at-most-`save_every` lost steps.

Straggler mitigation: within-step, SPMD training is bulk-synchronous,
so the mitigation is (a) flagging for re-scheduling, (b) excluding the
rank at the next elastic re-plan — both implemented here; (c)
microbatch-level work re-balancing is a DistSim what-if query.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_workers: int, straggler_factor: float = 1.5,
                 dead_after_s: float = 60.0, window: int = 16):
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(last_heartbeat=0.0) for i in range(n_workers)}
        self.straggler_factor = straggler_factor
        self.dead_after_s = dead_after_s
        self.window = window

    def heartbeat(self, worker: int, step_time: float,
                  now: Optional[float] = None):
        """Record a step heartbeat. A heartbeat from a worker
        previously marked dead re-joins it (elastic rescheduling
        brought the node back); its stale step-time history is dropped
        so straggler detection starts fresh."""
        w = self.workers[worker]
        if not w.alive:
            w.alive = True
            w.step_times.clear()
        w.last_heartbeat = now if now is not None else time.time()
        w.step_times.append(step_time)
        if len(w.step_times) > self.window:
            w.step_times.pop(0)

    def stragglers(self) -> List[int]:
        med = np.median([np.mean(w.step_times)
                         for w in self.workers.values()
                         if w.step_times and w.alive] or [0.0])
        if med == 0.0:
            return []
        return [i for i, w in self.workers.items()
                if w.alive and w.step_times
                and np.mean(w.step_times) > self.straggler_factor * med]

    def dead(self, now: Optional[float] = None) -> List[int]:
        """Pure query: workers currently overdue (alive but silent for
        longer than ``dead_after_s``). Does NOT change state — call
        :meth:`mark_dead` to transition them, so callers that poll
        twice (or several pollers sharing one monitor) all see the
        same death."""
        now = now if now is not None else time.time()
        return [i for i, w in self.workers.items()
                if w.alive and now - w.last_heartbeat > self.dead_after_s]

    def mark_dead(self, workers: Optional[List[int]] = None,
                  now: Optional[float] = None) -> List[int]:
        """State transition: mark ``workers`` (default: the current
        :meth:`dead` set) as dead; returns the workers actually
        transitioned. A later :meth:`heartbeat` re-joins them."""
        targets = self.dead(now) if workers is None else workers
        out = []
        for i in targets:
            w = self.workers[i]
            if w.alive:
                w.alive = False
                out.append(i)
        return out

    def alive_count(self) -> int:
        return sum(w.alive for w in self.workers.values())


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def replan_mesh(survivors: int, model_parallel: int) -> ElasticPlan:
    """Largest usable (data, model) grid after failures.

    Keeps `model` intact if possible (TP re-sharding moves the most
    bytes); drops to the largest power-of-two data degree that fits.
    """
    if survivors < 1:
        raise ValueError(
            f"replan_mesh needs at least one survivor, got {survivors}")
    mp = model_parallel
    while mp > 1 and survivors < mp:
        mp //= 2
    data = 1
    while data * 2 * mp <= survivors:
        data *= 2
    return ElasticPlan(data=data, model=mp)


def run_with_recovery(n_steps: int,
                      step_fn: Callable[[int], float],
                      save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      save_every: int = 10,
                      failure_at: Optional[int] = None,
                      max_recoveries: int = 8) -> Tuple[int, int]:
    """Driver with checkpoint/restart. ``step_fn(step)`` may raise
    RuntimeError (simulated node failure); we restore and continue.
    Returns (completed_steps, n_recoveries).

    ``max_recoveries`` bounds the restart budget: a persistent failure
    (e.g. a step that deterministically raises) would otherwise loop
    forever, since ``restore_fn`` rewinds to the same step each time.
    When the budget is exhausted the last failure is re-raised with
    recovery context chained on it."""
    recoveries = 0
    step = restore_fn()
    while step < n_steps:
        try:
            if failure_at is not None and step == failure_at:
                failure_at = None          # fail exactly once
                raise RuntimeError("simulated node failure")
            step_fn(step)
            step += 1
            if step % save_every == 0:
                save_fn(step)
        except RuntimeError as exc:
            recoveries += 1
            if recoveries > max_recoveries:
                raise RuntimeError(
                    f"persistent failure at step {step}: recovery "
                    f"budget exhausted after {max_recoveries} "
                    f"recoveries") from exc
            step = restore_fn()
    return step, recoveries
