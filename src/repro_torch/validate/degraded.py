"""Degraded-fleet validation matrix: perturbed runs under structural
gates.

The happy-path sweep (:mod:`repro_torch.validate.sweep`) gates predict vs
replay conformance; this module gates the *perturbation axis* — the
spliced straggler/fault timelines of ``DistSim.simulate(perturb=...)``
— on invariants that must hold for ANY cost model:

* segments tile the run exactly (``[0, steps)``, contiguous, in order);
* checkpoint arithmetic (``ckpt_step`` on a ``save_every`` boundary,
  ``lost = at_step - ckpt_step``);
* recovery components non-negative, restore-read strictly positive;
* the surviving grid only shrinks (``dp`` monotone non-increasing) and
  the effective global batch follows it (microbatch held constant);
* pure-straggler runs (all factors >= 1) never finish faster than the
  clean run on the same grid.

``benchmarks/bench_fault.py`` wraps :func:`run_degraded` for CI and
additionally pins the predicted recovery times / post-failure
throughput against goldens (``tests/goldens/validation_degraded.json``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.costmodel import A40_CLUSTER, ClusterSpec, get_cluster
from repro_torch.core.events import Strategy
from repro_torch.core.perturb import (DegradedRun, Fault, Perturbation,
                                      Straggler)
from repro_torch.core.profiler import Provider, provider_for
from repro_torch.core.simulator import DistSim


@dataclasses.dataclass(frozen=True)
class DegradedCell:
    """One matrix point: a model/strategy pair under one perturbation."""
    arch: str
    strategy: Strategy
    perturb: Perturbation
    global_batch: int = 16
    seq: int = 512
    smoke: bool = False
    xfail: str = ""                   # known-bad reason; reported, not gated

    def label(self) -> str:
        arch = self.arch + ("~smoke" if self.smoke else "")
        return f"{arch}/{self.strategy.label()}/{self.perturb.label()}"

    def config(self):
        cfg = get_config(self.arch)
        return smoke_config(cfg) if self.smoke else cfg


@dataclasses.dataclass
class DegradedCellResult:
    cell: DegradedCell
    run: DegradedRun
    baseline_total: np.ndarray        # (S,) clean run on the original grid
    violations: List[str]

    @property
    def passed(self) -> bool:
        return not self.violations

    @property
    def gates(self) -> bool:
        return not self.cell.xfail

    def to_dict(self) -> Dict:
        return {
            "label": self.cell.label(),
            "violations": list(self.violations),
            "baseline_total": [float(t) for t in self.baseline_total],
            "total_times": [float(t) for t in self.run.total_times],
            "recovery_times": [
                [float(t) for t in r.recovery_times]
                for r in self.run.recoveries],
            "post_failure_throughput": [
                float(t) for t in self.run.post_failure_throughput],
            "effective_global_batch": self.run.effective_global_batch,
            "final_strategy": self.run.final_strategy.label(),
            "steps_lost": self.run.steps_lost,
        }


@dataclasses.dataclass
class DegradedReport:
    cells: List[DegradedCellResult]
    cluster: str
    seeds: Optional[List[int]]

    @property
    def failures(self) -> List[DegradedCellResult]:
        return [c for c in self.cells if c.gates and not c.passed]

    @property
    def passed(self) -> bool:
        return not self.failures

    def to_dict(self) -> Dict:
        return {"cluster": self.cluster,
                "seeds": list(self.seeds) if self.seeds else None,
                "cells": [c.to_dict() for c in self.cells]}


# --------------------------------------------------------------------------
# the matrix
# --------------------------------------------------------------------------

def _cell(arch, mp, pp, dp, m, schedule, perturb, gb=16, seq=512,
          smoke=False, zero1=False, xfail="") -> DegradedCell:
    return DegradedCell(
        arch, Strategy(mp=mp, pp=pp, dp=dp, microbatches=m,
                       schedule=schedule, zero1=zero1),
        perturb=perturb, global_batch=gb, seq=seq, smoke=smoke,
        xfail=xfail)


def degraded_matrix() -> List[DegradedCell]:
    """CI-scale degraded-fleet matrix: a straggler ladder (the first
    two cells differ only in ``factor`` — bench_fault gates
    monotonicity across them), a windowed per-replica straggler, and
    fault/recovery cells covering dp shrink, straggler-then-fault,
    ZeRO-1 restore sharding, and a double fault on a pure-DP grid."""
    def slow(f, w=(0, -1)):
        return (Straggler(1, f, w), Straggler(3, f, w))
    return [
        # straggler ladder — pipeline device 1 of BOTH replicas (ranks
        # 1 and 3 of the 1M2P2D flat grid), factors 1.25 then 1.5
        _cell("gpt2_345m", 1, 2, 2, 4, "1f1b",
              Perturbation(stragglers=slow(1.25), steps=8)),
        _cell("gpt2_345m", 1, 2, 2, 4, "1f1b",
              Perturbation(stragglers=slow(1.5), steps=8)),
        # windowed single-rank straggler: per-replica (non-uniform
        # across dp), exercises the segment cuts at the window edges
        _cell("gpt2_345m", 1, 2, 2, 4, "1f1b",
              Perturbation(stragglers=(Straggler(1, 2.0, (2, 6)),),
                           steps=8)),
        # fault at step 6 with checkpoints every 4: restore from step
        # 4, recompute 2 steps, dp 2 -> 1 (mp*pp group kept intact)
        _cell("gpt2_345m", 1, 2, 2, 4, "1f1b",
              Perturbation(faults=(Fault(3, 6, detect_s=0.5),),
                           steps=12, save_every=4)),
        # hybrid mp·pp grid, straggler window then a fault: the
        # post-replan segment must run clean (mitigation (b))
        _cell("bert_large", 2, 2, 2, 4, "1f1b",
              Perturbation(stragglers=(Straggler(2, 1.5, (0, 4)),),
                           faults=(Fault(7, 5),),
                           steps=10, save_every=5, replan_s=2.0)),
        # ZeRO-1: optimizer moments dp-sharded, so the restore read is
        # smaller than the replicated-optimizer equivalent
        _cell("t5_large", 1, 2, 2, 4, "1f1b",
              Perturbation(faults=(Fault(1, 3),), steps=8, save_every=2),
              zero1=True),
        # pure-DP double fault: dp 4 -> 2 -> 2 (power-of-two replan)
        _cell("gpt2_345m", 1, 1, 4, 2, "1f1b",
              Perturbation(faults=(Fault(0, 3), Fault(2, 7,
                                                      detect_s=1.0)),
                           steps=10, save_every=4)),
    ]


# --------------------------------------------------------------------------
# structural gates
# --------------------------------------------------------------------------

def structural_violations(cell: DegradedCell, run: DegradedRun,
                          baseline_total: np.ndarray) -> List[str]:
    """Cost-model-independent invariants of a spliced degraded run."""
    out: List[str] = []
    p = cell.perturb

    # segments tile [0, steps) contiguously and in order
    spans = [(s.start, s.stop) for s in run.segments]
    ok = bool(spans) and spans[0][0] == 0 and spans[-1][1] == p.steps \
        and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if not ok:
        out.append("segment_cover")

    # checkpoint arithmetic
    for r in run.recoveries:
        if (r.ckpt_step % p.save_every or
                r.lost_steps != r.fault.at_step - r.ckpt_step):
            out.append("ckpt_arithmetic")
            break

    # recovery components: all non-negative, restore strictly positive
    for r in run.recoveries:
        durs = {e.kind: e.duration for e in r.events}
        if any(np.any(d < 0) for d in durs.values()) \
                or not np.all(durs["restore"] > 0):
            out.append("recovery_component")
            break

    # the surviving grid only shrinks, and gb follows it
    dp0, dpf = cell.strategy.dp, run.final_strategy.dp
    if dpf > dp0:
        out.append("dp_grew")
    if run.effective_global_batch != \
            (cell.global_batch // dp0) * dpf:
        out.append("effective_gb")

    if not np.all(run.post_failure_throughput > 0):
        out.append("throughput")

    # pure-straggler runs with slowdown factors never beat the clean
    # run (faults excluded: a shrunk grid can legitimately step faster)
    if not p.faults and all(s.factor >= 1.0 for s in p.stragglers):
        if np.any(run.total_times < baseline_total - 1e-12):
            out.append("faster_than_clean")

    return out


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

def run_degraded_cell(cell: DegradedCell, provider: Provider,
                      seeds: Union[int, Sequence[int], None] = None,
                      jitter_sigma: float = 0.025) -> DegradedCellResult:
    sim = DistSim(cell.config(), cell.strategy, cell.global_batch,
                  cell.seq, provider)
    run = sim.simulate(perturb=cell.perturb, seeds=seeds,
                       jitter_sigma=jitter_sigma)
    baseline_total = cell.perturb.steps * run.baseline_step_time
    return DegradedCellResult(
        cell=cell, run=run, baseline_total=baseline_total,
        violations=structural_violations(cell, run, baseline_total))


def run_degraded(cells: Optional[Sequence[DegradedCell]] = None,
                 cluster: Union[str, ClusterSpec, None] = None,
                 seeds: Union[int, Sequence[int], None] = None,
                 jitter_sigma: float = 0.025,
                 provider: Optional[Provider] = None) -> DegradedReport:
    """Run the degraded matrix; one shared provider, so the unique-event
    dedup applies across cells exactly as in the happy-path sweep."""
    if isinstance(cluster, str):
        cluster = get_cluster(cluster)
    cells = list(cells) if cells is not None else degraded_matrix()
    if (provider is not None and cluster is not None
            and provider.cluster != cluster):
        raise ValueError(
            f"cluster {cluster.name!r} disagrees with the provider's "
            f"{provider.cluster.name!r}; pass one or the other")
    provider = provider or provider_for(cluster or A40_CLUSTER)
    results = [run_degraded_cell(c, provider, seeds, jitter_sigma)
               for c in cells]
    if isinstance(seeds, (int, np.integer)):
        seed_list: Optional[List[int]] = [int(seeds)]
    else:
        seed_list = list(seeds) if seeds is not None else None
    return DegradedReport(cells=results,
                          cluster=provider.cluster.name,
                          seeds=seed_list)


def format_degraded_report(report: DegradedReport) -> str:
    lines = [f"degraded matrix on {report.cluster} "
             f"(seeds={report.seeds or 'predict'})"]
    for c in report.cells:
        run = c.run
        mark = "PASS" if c.passed else \
            f"FAIL[{','.join(c.violations)}]"
        if c.cell.xfail:
            mark += f" (xfail: {c.cell.xfail})"
        t = float(run.total_times[0])
        b = float(c.baseline_total[0])
        extra = ""
        if run.recoveries:
            rec = sum(float(r.recovery_times[0])
                      for r in run.recoveries)
            extra = (f" recovery={rec:.3f}s lost={run.steps_lost} "
                     f"-> {run.final_strategy.label()}"
                     f" gb={run.effective_global_batch}")
        lines.append(f"  {mark:<28} {c.cell.label():<60} "
                     f"total={t:.3f}s clean={b:.3f}s "
                     f"x{t / b:.2f}{extra}")
    n_fail = len(report.failures)
    lines.append(f"{len(report.cells)} cells, {n_fail} failures -> "
                 + ("PASS" if report.passed else "FAIL"))
    return "\n".join(lines)
