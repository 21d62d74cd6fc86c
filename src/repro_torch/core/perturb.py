"""Perturbation axis: stragglers and injected failures as first-class
simulation inputs (ROADMAP "failure/straggler scenarios").

The paper's §6 use-case — evaluate a strategy *before* renting the
cluster — only covers the happy path. This module extends the same
event machinery to degraded fleets:

* :class:`Straggler` — a per-device slowdown multiplier over a step
  window. Inside a step, TPU/GPU SPMD is bulk-synchronous, so a slow
  device stretches every event it executes; the engine applies the
  multiplier to the replay-side ``speed`` plane (the exact mechanism
  the stochastic ``straggler_sigma`` noise already uses), which keeps
  the zero-perturbation path bit-identical.

* :class:`Fault` — rank dies at the start of a step. Recovery is
  modeled as timeline events, wiring the dormant seed subsystems into
  the engine: a restore-read ``hbm`` event sized from a
  :mod:`repro_torch.train.checkpoint` manifest, a mesh re-plan via
  :func:`repro_torch.train.fault_tolerance.replan_mesh`, and resumed steps on
  the surviving :class:`~repro_torch.train.fault_tolerance.ElasticPlan` grid
  (recomputing the steps lost since the last checkpoint).

* :func:`simulate_degraded` — splices segments and recovery sub-graphs
  into one :class:`DegradedRun`; the public entry point is
  ``DistSim.simulate(perturb=...)``.

Design invariants (the repo's standing bit-identity bar):

* ``perturb=None`` — and an empty :class:`Perturbation` — leave every
  replay/predict path byte-identical to the unperturbed engine: no
  extra RNG draws, no changed operand pairings, no key changes.
* Builds, engines, store addresses and serve-query serialization do
  NOT depend on the perturbation: a perturbation multiplies profiled
  means at run evaluation time, so ``ProfileStore``/``BuildCache``
  keys carry no perturb field and every existing address stays
  byte-identical (the scenario-key pattern: optional axis
  serialized only when present).
* Straggler ``rank`` is the flat device index of the ``(dp, pp, mp)``
  grid — ``rank = (r * pp + d) * mp + j`` — matching the engine's
  activity device numbering. SPMD lockstep means a straggling rank
  stalls its whole mp group, so the grid resolves to a ``(dp, pp)``
  multiplier plane.
* After an elastic re-plan the flagged stragglers are excluded from
  the surviving grid (fault-tolerance mitigation (b): straggling ranks
  are dropped at the next re-plan), so post-failure segments run clean.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.engine import EventFlowEngine
from repro_torch.core.events import Event, Strategy
from repro_torch.train.checkpoint import manifest_nbytes, synthetic_manifest
from repro_torch.train.fault_tolerance import ElasticPlan, replan_mesh

#: open-ended straggler window sentinel (active until the run ends)
OPEN = -1


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Rank runs ``factor``x slower over ``window = [start, stop)``
    run steps (``stop = OPEN`` keeps it active until the end)."""
    rank: int
    factor: float
    window: Tuple[int, int] = (0, OPEN)

    def __post_init__(self):
        object.__setattr__(self, "window", tuple(self.window))
        if self.rank < 0:
            raise ValueError(f"straggler rank must be >= 0, got {self.rank}")
        if not self.factor > 0:
            raise ValueError(
                f"straggler factor must be > 0, got {self.factor}")
        w0, w1 = self.window
        if w0 < 0 or (w1 != OPEN and w1 <= w0):
            raise ValueError(f"bad straggler window {self.window}: want "
                             f"(start >= 0, stop > start or OPEN)")

    def covers(self, step: int) -> bool:
        w0, w1 = self.window
        return w0 <= step and (w1 == OPEN or step < w1)


@dataclasses.dataclass(frozen=True)
class Fault:
    """Rank dies at the start of run step ``at_step``; ``detect_s`` is
    the heartbeat-timeout detection latency charged before recovery."""
    rank: int
    at_step: int
    detect_s: float = 0.0

    def __post_init__(self):
        if self.rank < 0:
            raise ValueError(f"fault rank must be >= 0, got {self.rank}")
        if self.at_step < 0:
            raise ValueError(
                f"fault at_step must be >= 0, got {self.at_step}")
        if self.detect_s < 0:
            raise ValueError(
                f"fault detect_s must be >= 0, got {self.detect_s}")


@dataclasses.dataclass(frozen=True)
class Perturbation:
    """A degraded-fleet scenario: stragglers + faults over a run of
    ``steps`` training/serving iterations, checkpointing every
    ``save_every`` steps (absolute step numbers), with ``replan_s``
    seconds of mesh re-plan overhead charged per recovery."""
    stragglers: Tuple[Straggler, ...] = ()
    faults: Tuple[Fault, ...] = ()
    steps: int = 16
    save_every: int = 4
    replan_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "stragglers", tuple(self.stragglers))
        faults = tuple(sorted(self.faults, key=lambda f: f.at_step))
        object.__setattr__(self, "faults", faults)
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.save_every < 1:
            raise ValueError(
                f"save_every must be >= 1, got {self.save_every}")
        if self.replan_s < 0:
            raise ValueError(
                f"replan_s must be >= 0, got {self.replan_s}")
        ranks = [f.rank for f in faults]
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"duplicate fault ranks: {ranks}")
        for f in faults:
            if f.at_step >= self.steps:
                raise ValueError(
                    f"fault at_step {f.at_step} outside the run "
                    f"(steps={self.steps})")

    # ---- engine-facing views ----

    def speed_grid(self, strat: Strategy) -> Optional[np.ndarray]:
        """(dp, pp) duration multiplier plane, or None when no
        straggler is present (the engine then takes the exact
        unperturbed path). All stragglers in the spec are applied —
        window selection happens at the run level via :meth:`active`;
        callers that splice segments pass per-segment sub-specs."""
        if not self.stragglers:
            return None
        dp, pp, mp = strat.dp, strat.pp, strat.mp
        world = dp * pp * mp
        grid = np.ones((dp, pp))
        for s in self.stragglers:
            if s.rank >= world:
                raise ValueError(
                    f"straggler rank {s.rank} out of range for the "
                    f"{world}-device strategy {strat.label()}")
            r, d = divmod(s.rank // mp, pp)
            grid[r, d] *= s.factor
        return grid

    def pipe_scale(self, strat: Strategy) -> Optional[np.ndarray]:
        """(pp,) per-pipeline-device multiplier for single-replica
        array programs (:class:`repro_torch.core.megabatch.MegaBatch`);
        raises when the effect varies across DP replicas (the
        single-replica program cannot represent that — use
        ``EventFlowEngine.run``/``run_batched`` instead)."""
        grid = self.speed_grid(strat)
        if grid is None:
            return None
        if strat.dp > 1 and not bool(np.all(grid == grid[0])):
            raise ValueError(
                "mega-batch predict needs straggler effects uniform "
                "across DP replicas; use EventFlowEngine.run/"
                "run_batched for per-replica perturbations")
        return grid[0]

    def active(self, step: int) -> Tuple[Straggler, ...]:
        """Stragglers whose window covers ``step``."""
        return tuple(s for s in self.stragglers if s.covers(step))

    # ---- serde (report/query embedding) ----

    def to_dict(self) -> Dict:
        return {
            "stragglers": [_straggler_dict(s) for s in self.stragglers],
            "faults": [dataclasses.asdict(f) for f in self.faults],
            "steps": self.steps,
            "save_every": self.save_every,
            "replan_s": self.replan_s,
        }

    def label(self) -> str:
        parts = []
        for s in self.stragglers:
            w = ("" if s.window == (0, OPEN)
                 else f"@{s.window[0]}:{s.window[1]}")
            parts.append(f"slow{s.rank}x{s.factor:g}{w}")
        for f in self.faults:
            parts.append(f"fault{f.rank}@{f.at_step}")
        return "+".join(parts) if parts else "clean"


def _straggler_dict(s: Straggler) -> Dict:
    # JSON-native (window as a list), so to_dict() round-trips through
    # json.dumps unchanged
    return {"rank": s.rank, "factor": s.factor, "window": list(s.window)}


def perturbation_from_dict(d: Optional[Dict]) -> Optional[Perturbation]:
    """Inverse of :meth:`Perturbation.to_dict`; ``None`` (the omitted
    default in serialized queries/reports) stays ``None``."""
    if d is None:
        return None
    return Perturbation(
        stragglers=tuple(Straggler(rank=s["rank"], factor=s["factor"],
                                   window=tuple(s.get("window", (0, OPEN))))
                         for s in d.get("stragglers", ())),
        faults=tuple(Fault(**f) for f in d.get("faults", ())),
        steps=d.get("steps", 16),
        save_every=d.get("save_every", 4),
        replan_s=d.get("replan_s", 0.0),
    )


# --------------------------------------------------------------------------
# degraded-run composition (segments + recovery sub-graphs)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Segment:
    """A run span of identical per-step conditions: ``[start, stop)``
    steps on one strategy grid under one active-straggler set."""
    start: int
    stop: int
    strategy: str                       # Strategy.label() of the grid
    stragglers: Tuple[Straggler, ...]
    step_times: np.ndarray              # (S,) per replay lane

    @property
    def total(self) -> np.ndarray:
        return (self.stop - self.start) * self.step_times

    def to_dict(self) -> Dict:
        return {"start": self.start, "stop": self.stop,
                "strategy": self.strategy,
                "stragglers": [_straggler_dict(s)
                               for s in self.stragglers],
                "step_times": [float(t) for t in self.step_times]}


@dataclasses.dataclass
class RecoveryEvent:
    """One component of a recovery sub-graph (spliced at the failure
    step): detect / restore / replan / recompute."""
    kind: str
    duration: np.ndarray                # (S,) per replay lane

    def to_dict(self) -> Dict:
        return {"kind": self.kind,
                "duration": [float(t) for t in self.duration]}


@dataclasses.dataclass
class FaultRecovery:
    """The recovery timeline spliced for one fault."""
    fault: Fault
    ckpt_step: int                      # checkpoint restored from
    lost_steps: int                     # recomputed on the new grid
    survivors: int
    plan: ElasticPlan
    restore_bytes: float                # manifest total (all devices)
    events: List[RecoveryEvent]

    @property
    def recovery_times(self) -> np.ndarray:
        """(S,) failure-to-caught-up time: detect + restore + replan +
        recompute of the steps lost since the checkpoint."""
        out = np.zeros_like(self.events[0].duration)
        for e in self.events:
            out = out + e.duration
        return out

    def to_dict(self) -> Dict:
        return {"rank": self.fault.rank, "at_step": self.fault.at_step,
                "ckpt_step": self.ckpt_step,
                "lost_steps": self.lost_steps,
                "survivors": self.survivors,
                "plan": {"data": self.plan.data, "model": self.plan.model},
                "restore_bytes": self.restore_bytes,
                "recovery_times": [float(t) for t in self.recovery_times],
                "events": [e.to_dict() for e in self.events]}


@dataclasses.dataclass
class DegradedRun:
    """Result of ``DistSim.simulate(perturb=...)``: the spliced
    timeline of a perturbed multi-step run. Arrays are (S,) — one entry
    per replay lane (S=1 zero-noise predict when ``seeds`` is None)."""
    perturb: Perturbation
    seeds: List[Optional[int]]
    steps: int                          # run steps actually delivered
    baseline_step_time: np.ndarray      # (S,) unperturbed original grid
    segments: List[Segment]
    recoveries: List[FaultRecovery]
    entries: List                       # ordered ("segment"|"recovery", x)
    final_strategy: Strategy
    post_failure_step_time: np.ndarray  # (S,) clean final grid
    post_failure_throughput: np.ndarray  # (S,) tokens/sec on final grid
    effective_global_batch: int

    @property
    def total_times(self) -> np.ndarray:
        """(S,) wall-clock of the whole perturbed run."""
        out = np.zeros_like(self.baseline_step_time)
        for kind, x in self.entries:
            out = out + (x.total if kind == "segment"
                         else x.recovery_times)
        return out

    @property
    def steps_lost(self) -> int:
        return sum(r.lost_steps for r in self.recoveries)

    def timeline(self, lane: int = 0) -> List[Tuple[str, float, float, str]]:
        """Flat ``(kind, t0, t1, label)`` spans for lane ``lane`` —
        segments and recovery components in splice order."""
        out: List[Tuple[str, float, float, str]] = []
        t = 0.0
        for kind, x in self.entries:
            if kind == "segment":
                dt = float(x.total[lane])
                lab = (f"steps {x.start}..{x.stop} on {x.strategy}"
                       + (f" ({len(x.stragglers)} stragglers)"
                          if x.stragglers else ""))
                out.append(("steps", t, t + dt, lab))
                t += dt
            else:
                for e in x.events:
                    dt = float(e.duration[lane])
                    out.append((e.kind, t, t + dt,
                                f"rank {x.fault.rank} fault @ step "
                                f"{x.fault.at_step}"))
                    t += dt
        return out

    def to_dict(self) -> Dict:
        return {
            "perturb": self.perturb.to_dict(),
            "seeds": list(self.seeds),
            "steps": self.steps,
            "steps_lost": self.steps_lost,
            "baseline_step_time": [float(t)
                                   for t in self.baseline_step_time],
            "total_times": [float(t) for t in self.total_times],
            "post_failure_step_time": [
                float(t) for t in self.post_failure_step_time],
            "post_failure_throughput": [
                float(t) for t in self.post_failure_throughput],
            "effective_global_batch": self.effective_global_batch,
            "final_strategy": self.final_strategy.to_dict(),
            "segments": [s.to_dict() for s in self.segments],
            "recoveries": [r.to_dict() for r in self.recoveries],
        }


def restore_manifest(stages, strat: Strategy, step: int) -> Dict:
    """Synthetic checkpoint manifest for one strategy's shards: per
    pipeline position, the mp-sharded params plus the two AdamW moments
    (dp-sharded under ZeRO-1) — the bytes a real ``checkpoint.save``
    manifest of this model would describe, without writing arrays."""
    named: Dict[str, float] = {}
    for p, st in enumerate(stages):
        shard = st.param_bytes / max(1, strat.mp)
        moment = shard / strat.dp if strat.zero1 else shard
        named[f"pos{p}/params"] = shard
        named[f"pos{p}/adam_m"] = moment
        named[f"pos{p}/adam_v"] = moment
    return synthetic_manifest(step, named)


def _restore_read(manifest: Dict, strat: Strategy, provider
                  ) -> Tuple[float, float]:
    """(restore_time, total_bytes): every surviving pipeline device
    reads its own positions' shards in parallel — one ``hbm`` event per
    device, the recovery time is the slowest read."""
    pp = strat.pp
    per_dev = [0.0] * pp
    for e in manifest["leaves"]:
        p = int(e["path"].split("/", 1)[0][3:])
        n = 1
        for sdim in e["shape"]:
            n *= int(sdim)
        per_dev[p % pp] += n * np.dtype(e["dtype"]).itemsize
    times = [provider.time(Event(kind="hbm", name=f"ckpt_restore:d{d}",
                                 nbytes=b))
             for d, b in enumerate(per_dev)]
    return max(times), manifest_nbytes(manifest)


def simulate_degraded(sim, perturb: Perturbation,
                      seeds: Union[int, Sequence[int], None] = None,
                      jitter_sigma: float = 0.025,
                      straggler_sigma: float = 0.0,
                      clock_sigma: float = 0.0) -> DegradedRun:
    """Model a perturbed ``perturb.steps``-step run of ``sim``.

    Straggler windows split the run into segments (each a perturbed
    per-step engine evaluation); each fault splices a recovery
    sub-graph — detect, checkpoint restore-read (``hbm`` events sized
    from a :func:`restore_manifest`), mesh re-plan
    (:func:`~repro_torch.train.fault_tolerance.replan_mesh`, keeping the
    ``mp*pp`` model group intact or raising), and recomputation of the
    steps lost since the last checkpoint on the surviving grid.

    The surviving grid keeps the microbatch size constant (the
    compiled kernels / stage events are dp-independent), so a shrunk
    fleet delivers a smaller effective global batch:
    ``gb' = gb / dp * dp'``. Post-replan segments run without
    stragglers (flagged ranks are excluded at the re-plan).
    """
    strat0: Strategy = sim.strategy
    sc = sim.scenario
    if perturb.faults and not sc.is_train:
        raise ValueError(
            f"fault recovery (checkpoint restore) is a training-run "
            f"concept; scenario {sc.label()!r} supports stragglers only")
    world = strat0.devices
    for f in perturb.faults:
        if f.rank >= world:
            raise ValueError(
                f"fault rank {f.rank} out of range for the "
                f"{world}-device strategy {strat0.label()}")
    if seeds is None:
        lane_seeds = None
    elif isinstance(seeds, (int, np.integer)):
        lane_seeds = [int(seeds)]
    else:
        lane_seeds = list(seeds)

    def step_times(engine: EventFlowEngine,
                   p: Optional[Perturbation]) -> np.ndarray:
        if lane_seeds is None:
            return engine.run_batched(None, perturb=p).batch_times
        return engine.run_batched(
            lane_seeds, jitter_sigma=jitter_sigma,
            straggler_sigma=straggler_sigma, clock_sigma=clock_sigma,
            perturb=p).batch_times

    base_engine: EventFlowEngine = sim.engine()
    baseline = step_times(base_engine, None)
    S = len(baseline)

    engines: Dict[Strategy, EventFlowEngine] = {strat0: base_engine}

    def engine_for(strat: Strategy) -> EventFlowEngine:
        eng = engines.get(strat)
        if eng is None:
            # stage events are dp-independent (microbatch held
            # constant), so the surviving engine reuses the positions
            eng = EventFlowEngine(base_engine.stages, strat,
                                  sim.provider, scenario=sc)
            engines[strat] = eng
        return eng

    segments: List[Segment] = []
    recoveries: List[FaultRecovery] = []
    entries: List = []

    def run_span(a: int, b: int, engine: EventFlowEngine,
                 strat: Strategy, allow_strag: bool) -> None:
        if b <= a:
            return
        if not (allow_strag and perturb.stragglers):
            pieces = [(a, b, ())]
        else:
            cuts = {a, b}
            for s in perturb.stragglers:
                w0, w1 = s.window
                for c in (w0, b if w1 == OPEN else w1):
                    if a < c < b:
                        cuts.add(c)
            cs = sorted(cuts)
            pieces = [(lo, hi, perturb.active(lo))
                      for lo, hi in zip(cs, cs[1:])]
        for lo, hi, active in pieces:
            p_seg = Perturbation(stragglers=active) if active else None
            seg = Segment(start=lo, stop=hi, strategy=strat.label(),
                          stragglers=tuple(active),
                          step_times=step_times(engine, p_seg))
            segments.append(seg)
            entries.append(("segment", seg))

    mp_model = strat0.mp * strat0.pp
    cur_strat, cur_engine = strat0, base_engine
    step = 0
    dead = 0
    for f in perturb.faults:
        run_span(step, f.at_step, cur_engine, cur_strat,
                 allow_strag=(dead == 0))
        step = f.at_step
        dead += 1
        survivors = world - dead
        plan = replan_mesh(survivors, mp_model)
        if plan.model != mp_model:
            raise ValueError(
                f"unrecoverable failure at step {f.at_step}: "
                f"{survivors} survivors cannot hold the "
                f"mp*pp={mp_model} model-parallel group "
                f"(replan proposes {plan})")
        ckpt_step = (f.at_step // perturb.save_every) * perturb.save_every
        lost = f.at_step - ckpt_step
        new_strat = (cur_strat if plan.data == cur_strat.dp
                     else dataclasses.replace(cur_strat, dp=plan.data))
        new_engine = engine_for(new_strat)
        manifest = restore_manifest(base_engine.stages, cur_strat,
                                    ckpt_step)
        restore_t, total_bytes = _restore_read(manifest, cur_strat,
                                               sim.provider)
        recompute = lost * step_times(new_engine, None)
        rec = FaultRecovery(
            fault=f, ckpt_step=ckpt_step, lost_steps=lost,
            survivors=survivors, plan=plan, restore_bytes=total_bytes,
            events=[
                RecoveryEvent("detect", np.full(S, f.detect_s)),
                RecoveryEvent("restore", np.full(S, restore_t)),
                RecoveryEvent("replan", np.full(S, perturb.replan_s)),
                RecoveryEvent("recompute", recompute),
            ])
        recoveries.append(rec)
        entries.append(("recovery", rec))
        cur_strat, cur_engine = new_strat, new_engine
    run_span(step, perturb.steps, cur_engine, cur_strat,
             allow_strag=(dead == 0))

    post_step = step_times(cur_engine, None)
    gb_eff = (sim.global_batch if cur_strat.dp == strat0.dp
              else (sim.global_batch // strat0.dp) * cur_strat.dp)
    tput = np.divide(sc.tokens(gb_eff, sim.seq), post_step,
                     out=np.zeros_like(post_step), where=post_step > 0)
    return DegradedRun(
        perturb=perturb,
        seeds=(list(lane_seeds) if lane_seeds is not None else [None]),
        steps=perturb.steps,
        baseline_step_time=baseline,
        segments=segments, recoveries=recoveries, entries=entries,
        final_strategy=cur_strat,
        post_failure_step_time=post_step,
        post_failure_throughput=tput,
        effective_global_batch=gb_eff)
