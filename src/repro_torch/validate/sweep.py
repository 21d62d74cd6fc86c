"""Accuracy-sweep engine: predict() vs multi-seed replay() conformance.

The sweep runs DistSim's performance model against its discrete-event
replay oracle over a matrix of (model x schedule x hybrid strategy)
cells and gates each cell on the paper's §5 targets (<4% batch-time
error, <5% per-device activity error). Proteus/DistIR-style: the suite
exists so the event/timeline core can be refactored freely — any
fidelity drift trips the gate, not a reader's eye.

All cells on one cluster share a single profiling provider, so the
paper's unique-event dedup (Observation 1) applies across the whole
sweep: an event profiled for one cell is free for every later cell.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.costmodel import A40_CLUSTER, ClusterSpec, get_cluster
from repro_torch.core.events import Strategy
from repro_torch.core.profiler import Provider, provider_for
from repro_torch.core.scenario import TRAIN, Decode, Prefill, Scenario
from repro_torch.core.serde import dataclass_from_dict
from repro_torch.core.simulator import DistSim
from repro_torch.validate.build_cache import BuildCache
from repro_torch.validate.metrics import (CellMetrics, aggregate,
                                          compare_batch, compare_timelines)


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Pass/fail budgets per metric. Defaults are the paper's §5
    headline targets plus looser caps on the secondary deltas."""
    batch_time: float = 0.04          # §5.2: <4% iteration-time error
    activity: float = 0.05            # §5.3: <5% per-device activity error
    stage: float = 0.10               # §5.4 timestamp error, worst stage
    utilization: float = 0.10
    # worst single replay seed — so one bad draw can't hide in the
    # seed-mean that `batch_time` gates (1.5x the mean budget)
    batch_time_worst: float = 0.06

    def violations(self, m: CellMetrics) -> List[str]:
        out = []
        if m.batch_time_error > self.batch_time:
            out.append("batch_time")
        if m.worst_batch_time_error > self.batch_time_worst:
            out.append("batch_time_worst")
        if m.activity_error_max > self.activity:
            out.append("activity")
        if m.stage_error_max > self.stage:
            out.append("stage")
        if m.utilization_delta_max > self.utilization:
            out.append("utilization")
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Thresholds":
        return dataclass_from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class ValidationCell:
    """One sweep point: a model config under one hybrid strategy, in
    one scenario (training step by default; prefill/decode cells gate
    the serving event graphs against the same replay oracle)."""
    arch: str
    strategy: Strategy
    global_batch: int = 16
    seq: int = 512
    smoke: bool = False               # reduce the arch via smoke_config
    xfail: str = ""                   # known-bad reason; reported, not gated
    scenario: Scenario = TRAIN

    def label(self) -> str:
        arch = self.arch + ("~smoke" if self.smoke else "")
        sched = (f"/{self.strategy.schedule}:m{self.strategy.microbatches}"
                 if self.scenario.is_train
                 else f"/{self.scenario.label()}")
        return (f"{arch}/{self.strategy.label()}" + sched
                + (f":v{self.strategy.vpp}" if self.strategy.vpp > 1 else ""))

    def config(self):
        cfg = get_config(self.arch)
        return smoke_config(cfg) if self.smoke else cfg


@dataclasses.dataclass
class CellResult:
    cell: ValidationCell
    metrics: CellMetrics              # aggregated over seeds
    per_seed: List[CellMetrics]
    seeds: List[int]
    pred_batch_time: float
    replay_batch_times: List[float]
    violations: List[str]

    @property
    def passed(self) -> bool:
        return not self.violations

    @property
    def gates(self) -> bool:
        """Whether this cell participates in the pass/fail verdict."""
        return not self.cell.xfail


@dataclasses.dataclass
class SweepResult:
    cells: List[CellResult]
    thresholds: Thresholds
    cluster: str
    seeds: List[int]
    jitter_sigma: float

    @property
    def failures(self) -> List[CellResult]:
        return [c for c in self.cells if c.gates and not c.passed]

    @property
    def xpasses(self) -> List[CellResult]:
        """xfail cells that now pass — candidates for un-marking."""
        return [c for c in self.cells if not c.gates and c.passed]

    @property
    def passed(self) -> bool:
        return not self.failures


# --------------------------------------------------------------------------
# sweep matrices
# --------------------------------------------------------------------------

def _cell(arch, mp, pp, dp, m, schedule, vpp=1, gb=16, seq=512,
          smoke=False, xfail="", scenario=TRAIN) -> ValidationCell:
    return ValidationCell(
        arch, Strategy(mp=mp, pp=pp, dp=dp, microbatches=m,
                       schedule=schedule, vpp=vpp),
        global_batch=gb, seq=seq, smoke=smoke, xfail=xfail,
        scenario=scenario)


def smoke_matrix() -> List[ValidationCell]:
    """The CI gate: every model family x every schedule x dp/tp/pp mix,
    small enough to sweep in seconds on one CPU."""
    return [
        # gpt2_345m — dense decoder, all four schedules + pure DP
        _cell("gpt2_345m", 1, 2, 2, 4, "1f1b"),
        _cell("gpt2_345m", 1, 4, 1, 8, "gpipe"),
        _cell("gpt2_345m", 2, 2, 1, 4, "interleaved", vpp=2),
        _cell("gpt2_345m", 1, 2, 2, 4, "pipedream"),
        _cell("gpt2_345m", 1, 1, 4, 2, "1f1b"),
        # bert_large — dense encoder, tp+pp+dp hybrid
        _cell("bert_large", 2, 2, 2, 4, "1f1b"),
        _cell("bert_large", 1, 2, 2, 4, "gpipe"),
        # t5_large — encoder-decoder stage imbalance
        _cell("t5_large", 1, 2, 2, 4, "1f1b"),
        _cell("t5_large", 1, 4, 1, 8, "interleaved", vpp=2),
        # small MoE — EP all-to-all events under tp
        _cell("qwen3_moe_30b_a3b", 2, 2, 1, 4, "1f1b", smoke=True),
        _cell("qwen3_moe_30b_a3b", 1, 2, 2, 4, "gpipe", smoke=True),
    ]


def serving_matrix() -> List[ValidationCell]:
    """Serving-scenario gate: prefill + decode cells for the three
    serving-relevant families (VLM, SSM/attention hybrid, fine-grained
    MoE), smoke-reduced, gated at the same <4%/<5% thresholds as
    training. Decode cells include a continuous-batching variant
    (staggered per-slot arrivals) and a long-context KV read."""
    out: List[ValidationCell] = []
    for arch in ("qwen2_vl_72b", "jamba_v0_1_52b", "qwen3_moe_30b_a3b"):
        out.append(_cell(arch, 2, 2, 1, 4, "1f1b", gb=8, smoke=True,
                         scenario=Prefill()))
        out.append(_cell(arch, 1, 2, 2, 4, "1f1b", gb=8, smoke=True,
                         scenario=Decode(steps=8)))
    # continuous batching: slots arrive staggered mid-flight
    out.append(_cell("qwen3_moe_30b_a3b", 1, 2, 2, 4, "1f1b", gb=8,
                     smoke=True,
                     scenario=Decode(steps=6,
                                     arrivals=(0.0, 1e-4, 2e-4))))
    # long-context decode: KV read term dominates per-step time
    out.append(_cell("qwen2_vl_72b", 1, 1, 4, 2, "1f1b", gb=8,
                     smoke=True, scenario=Decode(steps=4, context=4096)))
    return out


def full_matrix() -> List[ValidationCell]:
    """Nightly-scale cross product (models x schedules x strategies);
    infeasible (batch-divisibility) combos are skipped. Extended with
    predict-scale scenario-diversity cells: full-size 52–145B models
    (dense, fine-grained MoE, SSM/attention hybrid, VLM) at 64–128
    device strategies — affordable because the 4 schedules of each
    (model, strategy) pair share one cached engine build and the sweep
    fans out across worker processes (``run_sweep(jobs=N)``)."""
    archs = [("gpt2_345m", False), ("bert_large", False),
             ("t5_large", False), ("qwen3_moe_30b_a3b", True)]
    strategies = [(1, 2, 2, 4), (2, 2, 2, 4), (1, 4, 1, 8), (2, 4, 1, 8),
                  (1, 1, 4, 2), (4, 2, 1, 4), (1, 2, 4, 4), (2, 1, 2, 4)]
    gb = 32
    out: List[ValidationCell] = []
    for arch, smoke in archs:
        for mp, pp, dp, m in strategies:
            if gb % (dp * m):
                continue
            for schedule in ("gpipe", "1f1b", "interleaved", "pipedream"):
                vpp = 2 if schedule == "interleaved" and pp > 1 else 1
                out.append(_cell(arch, mp, pp, dp, m, schedule, vpp=vpp,
                                 gb=gb, smoke=smoke))
    # predict-scale cells: full-size models, 64-128 devices
    big_archs = ["gpt_145b", "dbrx_132b", "jamba_v0_1_52b",
                 "qwen2_vl_72b"]
    big_strategies = [(8, 8, 2, 8), (2, 16, 2, 8)]
    for arch in big_archs:
        for mp, pp, dp, m in big_strategies:
            for schedule in ("gpipe", "1f1b", "interleaved", "pipedream"):
                vpp = 2 if schedule == "interleaved" else 1
                out.append(_cell(arch, mp, pp, dp, m, schedule, vpp=vpp,
                                 gb=64, seq=1024))
    return out


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

def run_cell(cell: ValidationCell, provider: Provider,
             seeds: Sequence[int] = (0, 1, 2),
             thresholds: Optional[Thresholds] = None,
             jitter_sigma: float = 0.025, batched: bool = True,
             cache: Optional[BuildCache] = None) -> CellResult:
    """One sweep point: one engine build, one batched replay over all
    seeds, array-native metrics (no ``Activity`` materialization).

    ``cache`` (a :class:`BuildCache` bound to ``provider``) serves the
    cell's engine content-addressed, so repeated (model, strategy)
    structure — e.g. the same pair under another schedule — skips the
    model-graph + event-mean rebuild; results are bit-identical either
    way. ``batched=False`` keeps the historical path — S sequential
    ``engine.run(seed=s)`` replays compared via materialized activity
    lists — as the differential baseline for
    ``tests/test_validation.py`` and the seed-scaling section of
    ``benchmarks/bench_timeline.py``.
    """
    thresholds = thresholds or Thresholds()
    sim = DistSim(cell.config(), cell.strategy, cell.global_batch,
                  cell.seq, provider,
                  scenario=getattr(cell, "scenario", TRAIN))
    if cache is not None:
        sim.use_engine(cache.engine_for(cell))
    if batched:
        pred_b = sim.simulate().batch
        rep_b = sim.simulate(seeds=seeds,
                             jitter_sigma=jitter_sigma).batch
        per_seed = compare_batch(pred_b, rep_b)
        pred_bt = float(pred_b.batch_times[0])
        replay_bts = [float(t) for t in rep_b.batch_times]
    else:
        # sequential differential baseline: one engine, one run() per
        # seed, activity-list comparison — deliberately NOT routed
        # through simulate() so it stays an independent oracle
        engine = sim.engine()
        pred_tl = engine.run()
        replay_tls = [engine.run(jitter_sigma=jitter_sigma, seed=s)
                      for s in seeds]
        per_seed = [compare_timelines(pred_tl, tl) for tl in replay_tls]
        pred_bt = pred_tl.batch_time
        replay_bts = [tl.batch_time for tl in replay_tls]
    metrics = aggregate(per_seed)
    return CellResult(
        cell=cell, metrics=metrics, per_seed=per_seed, seeds=list(seeds),
        pred_batch_time=pred_bt,
        replay_batch_times=replay_bts,
        violations=thresholds.violations(metrics))


def run_sweep(cells: Optional[Sequence[ValidationCell]] = None,
              cluster: Union[str, ClusterSpec, None] = None,
              seeds: Sequence[int] = (0, 1, 2),
              thresholds: Optional[Thresholds] = None,
              jitter_sigma: float = 0.025,
              provider: Optional[Provider] = None,
              batched: bool = True,
              cache: Union[bool, BuildCache] = True,
              jobs: int = 1,
              store=None) -> SweepResult:
    """Run the matrix; one shared provider = one event profile cache.

    ``cluster`` defaults to the provider's (or ``A40_CLUSTER`` when no
    provider is given); passing BOTH a cluster and a provider whose
    cluster disagrees raises ``ValueError`` — a silently-ignored
    cluster would sweep different hardware than asked.

    ``cache`` — ``True`` (default) shares one content-addressed
    :class:`BuildCache` across all cells (pass your own instance to
    keep it warm across *serial* sweeps, or ``False`` to rebuild per
    cell); either way the report is bit-identical. ``jobs > 1`` fans
    cells out across worker processes (:mod:`repro_torch.validate.executor`)
    with per-worker provider shards, merged back so the report — and
    the provider's unique-event accounting — matches the serial sweep.
    Workers build their own caches (engines hold unpicklable state),
    so with ``jobs > 1`` a passed instance only accumulates the
    shards' hit/miss accounting — it is neither consulted nor warmed;
    pass ``store`` to share warm state across processes instead.

    ``store`` — a :class:`repro_torch.store.ProfileStore` (or its directory
    path): profiled event times and engine builds are served from and
    persisted to disk, shared across sweeps, searches, executor
    workers and *processes*. With ``jobs > 1`` the workers open the
    store themselves instead of receiving the parent's pickled event
    cache. Store-served sweeps are bit-identical to cold runs.
    """
    if isinstance(cluster, str):
        cluster = get_cluster(cluster)
    cells = list(cells) if cells is not None else smoke_matrix()
    thresholds = thresholds or Thresholds()
    if provider is None and isinstance(cache, BuildCache):
        provider = cache.provider     # a warm cache implies its provider
    if (provider is not None and cluster is not None
            and provider.cluster != cluster):
        raise ValueError(
            f"cluster {cluster.name!r} disagrees with the provider's "
            f"{provider.cluster.name!r}; pass one or the other (the "
            f"provider's event times are profiled for ITS cluster)")
    provider = provider or provider_for(cluster or A40_CLUSTER)
    if isinstance(cache, BuildCache) and cache.provider is not provider:
        raise ValueError("cache is bound to a different provider than "
                         "the sweep's")
    if jobs and jobs > 1:
        from repro_torch.validate.executor import run_parallel
        results = run_parallel(
            cells, provider, seeds, thresholds, jitter_sigma, jobs=jobs,
            batched=batched, use_cache=bool(cache),
            cache_stats=cache.stats if isinstance(cache, BuildCache)
            else None, store=store)
    else:
        opened = None
        known = None
        if store is not None:
            from repro_torch.store import (PersistentBuildCache, open_store)
            opened = open_store(store)
        if isinstance(cache, BuildCache):
            bc: Optional[BuildCache] = cache
            if opened is not None \
                    and not isinstance(cache, PersistentBuildCache):
                raise ValueError(
                    "store given alongside a plain BuildCache instance;"
                    " pass cache=True (a PersistentBuildCache is built"
                    " for you) or a PersistentBuildCache")
        elif cache:
            bc = (PersistentBuildCache(provider, opened)
                  if opened is not None else BuildCache(provider))
        else:
            bc = None
            if opened is not None:
                # cache-less store-served sweep: events still come
                # from / go back to disk
                opened.load_events(provider)
                known = set(provider.cache_snapshot())
        results = [run_cell(c, provider, seeds, thresholds, jitter_sigma,
                            batched=batched, cache=bc)
                   for c in cells]
        if opened is not None:
            if bc is not None:
                bc.flush()
            else:
                delta = {e: t
                         for e, t in provider.cache_snapshot().items()
                         if e not in known}
                if delta:
                    opened.save_events(provider, delta)
    return SweepResult(cells=results, thresholds=thresholds,
                       cluster=provider.cluster.name, seeds=list(seeds),
                       jitter_sigma=jitter_sigma)
