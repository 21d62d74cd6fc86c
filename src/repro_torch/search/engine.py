"""Cached, pruned, multi-cluster strategy search engine (paper §6).

The naive workflow (seed ``grid_search``) rebuilt and re-profiled the
full event timeline per candidate. This engine applies the paper's
unique-event observation to the *search loop*:

* every candidate on a cluster shares one :class:`ProfileCache`
  provider, so an event appearing in many candidates is cost-evaluated
  once per search (``share_cache=False`` restores the naive
  per-candidate profiling for cross-checks and accounting);
* memory-infeasible candidates are skipped before any simulation, and
  candidates whose work lower bound already exceeds the best known
  batch time are pruned before full timeline construction;
* a list of ``ClusterSpec`` targets yields per-cluster rankings plus a
  cross-cluster Pareto frontier over (batch_time, HBM headroom,
  profiling cost);
* with ``megabatch=True`` (the default when the cache is shared) the
  grid's surviving candidates are scored by ONE
  :class:`repro_torch.core.megabatch.MegaBatch` array call per cluster
  instead of a per-cell Python predict: engines come from the
  cluster's :class:`~repro_torch.validate.build_cache.BuildCache` (shared
  positions/builds across schedule variants), the memory mask is an
  array op, and bound-pruning decisions are replayed in grid order
  over the vectorized batch times — entries, rankings and batch times
  are bit-identical to the per-cell path (differential oracle in
  ``tests/test_search_engine.py``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.configs.base import ArchConfig
from repro_torch.core.costmodel import ClusterSpec, H100_CLUSTER
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.events import Strategy, stage_event_set
from repro_torch.core.profiler import Provider, provider_for
from repro_torch.core.simulator import DistSim
from repro_torch.search.cache import ProfileCache
from repro_torch.search.prune import (HBM_BUDGET, estimate_memory,
                                      work_lower_bound)
from repro_torch.search.space import Candidate, enumerate_candidates


@dataclasses.dataclass
class SearchEntry:
    """One scored candidate. Field order up to ``reason`` is the seed
    ``repro_torch.core.search.SearchEntry`` layout (positional compat)."""
    strategy: Strategy
    batch_time: float               # predicted, or lower bound if pruned
    iters_per_s: float
    bubble_fraction: float
    feasible: bool
    reason: str = ""
    cluster: str = ""
    mem_bytes: float = 0.0
    hbm_headroom: float = 0.0
    profile_time_s: float = 0.0     # unique-event profiling cost
    pruned: bool = False


@dataclasses.dataclass
class SearchStats:
    candidates: int = 0             # grid points x clusters
    evaluated: int = 0              # full timeline constructions
    pruned_memory: int = 0
    pruned_bound: int = 0
    provider_evaluations: int = 0   # real cost-model evaluations
    cache_hits: int = 0
    wall_time_s: float = 0.0
    megabatch_lanes: int = 0        # candidates scored via array calls

    @property
    def candidates_per_s(self) -> float:
        return self.candidates / self.wall_time_s if self.wall_time_s \
            else 0.0


@dataclasses.dataclass
class SearchResult:
    entries: List[SearchEntry]              # all clusters, by batch_time
    by_cluster: Dict[str, List[SearchEntry]]
    pareto: List[SearchEntry]
    stats: SearchStats
    #: full specs of the searched clusters (serialized uniformly in
    #: search_report via ClusterSpec.to_dict, not by registry name)
    cluster_specs: Dict[str, ClusterSpec] = \
        dataclasses.field(default_factory=dict)

    def ranking(self, cluster: Optional[str] = None) -> List[SearchEntry]:
        """Fully-simulated feasible entries, fastest first (Table 2)."""
        pool = self.by_cluster.get(cluster, []) if cluster else self.entries
        return [e for e in pool if e.feasible and not e.pruned]

    def best(self, cluster: Optional[str] = None) -> Optional[SearchEntry]:
        rank = self.ranking(cluster)
        return rank[0] if rank else None


def pareto_frontier(entries: Sequence[SearchEntry]) -> List[SearchEntry]:
    """Non-dominated set: minimize batch_time and profile_time_s,
    maximize hbm_headroom."""

    def dominates(a: SearchEntry, b: SearchEntry) -> bool:
        no_worse = (a.batch_time <= b.batch_time
                    and a.profile_time_s <= b.profile_time_s
                    and a.hbm_headroom >= b.hbm_headroom)
        better = (a.batch_time < b.batch_time
                  or a.profile_time_s < b.profile_time_s
                  or a.hbm_headroom > b.hbm_headroom)
        return no_worse and better

    return [e for e in entries
            if not any(dominates(o, e) for o in entries if o is not e)]


class SearchEngine:
    """Scores a strategy grid on one or more clusters (the H100 cluster
    by default), each with the analytical provider of its chip unless
    ``provider_factory`` says otherwise.

    ``device`` is where the mega-batch programs are evaluated: the card
    by default (an error when there is none), the CPU only when the
    caller passes ``device="cpu"``; ``megabatch_backend="auto"`` then
    runs the Hopper scan kernel on the card and the plain PyTorch loop
    on the CPU."""

    def __init__(self, cfg: ArchConfig,
                 clusters: Union[ClusterSpec, Sequence[ClusterSpec],
                                 None] = None,
                 provider_factory=provider_for,
                 cache: Optional[ProfileCache] = None,
                 share_cache: bool = True,
                 prune: bool = True,
                 check_memory: bool = True,
                 megabatch: bool = True,
                 megabatch_backend: str = "auto",
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cache is not None:
            self.clusters = cache.clusters
        else:
            if clusters is None:
                clusters = (H100_CLUSTER,)
            elif isinstance(clusters, ClusterSpec):
                clusters = (clusters,)
            self.clusters = list(clusters)
        self.provider_factory = provider_factory
        self.share_cache = share_cache
        self.prune = prune
        self.check_memory = check_memory
        self.cache = cache if cache is not None else (
            ProfileCache.for_clusters(self.clusters, provider_factory)
            if share_cache else None)
        # the mega-batch path compiles engines out of the shared
        # BuildCache; without a shared cache it degrades to the naive
        # per-candidate loop (which is exactly what share_cache=False
        # exists to benchmark)
        self.megabatch = bool(megabatch and self.share_cache)
        self.megabatch_backend = megabatch_backend
        # compiled MegaBatch programs, keyed by engine identity — the
        # BuildCache returns the same engine objects on repeat searches,
        # so a warm search skips compilation and goes straight to eval
        self._megabatch_programs: "OrderedDict" = OrderedDict()

    def _provider(self, cluster: ClusterSpec) -> Provider:
        if self.share_cache:
            return self.cache.provider(cluster)
        return self.provider_factory(cluster)   # naive: fresh per candidate

    def search(self, n_devices: int, global_batch: int, seq: int,
               microbatches: Optional[Sequence[int]] = None,
               schedules: Sequence[str] = ("1f1b",),
               zero1_options: Sequence[bool] = (False,)) -> SearchResult:
        t0 = time.perf_counter()
        stats = SearchStats()
        base_evals = self.cache.evaluations if self.share_cache else 0
        base_hits = self.cache.hits if self.share_cache else 0
        grid = enumerate_candidates(n_devices, global_batch, microbatches,
                                    schedules, zero1_options)
        by_cluster: Dict[str, List[SearchEntry]] = {}
        search_cluster = (self._search_cluster_megabatch if self.megabatch
                          else self._search_cluster)
        for cluster in self.clusters:
            by_cluster[cluster.name] = search_cluster(
                cluster, grid, global_batch, seq, stats)

        entries = sorted((e for es in by_cluster.values() for e in es),
                         key=lambda e: e.batch_time)
        for es in by_cluster.values():
            es.sort(key=lambda e: e.batch_time)
        if self.share_cache:
            stats.provider_evaluations = self.cache.evaluations - base_evals
            stats.cache_hits = self.cache.hits - base_hits
        stats.wall_time_s = time.perf_counter() - t0
        pareto = pareto_frontier(
            [e for e in entries if e.feasible and not e.pruned])
        return SearchResult(entries, by_cluster, pareto, stats,
                            cluster_specs={c.name: c
                                           for c in self.clusters})

    def _search_cluster(self, cluster: ClusterSpec, grid: List[Candidate],
                        global_batch: int, seq: int,
                        stats: SearchStats) -> List[SearchEntry]:
        entries: List[SearchEntry] = []
        best_bt: Optional[float] = None
        budget = cluster.chip.hbm_bytes * HBM_BUDGET
        for cand in grid:
            stats.candidates += 1
            strat, micro = cand.strategy, cand.microbatch
            mem = estimate_memory(self.cfg, strat, micro, seq)
            headroom = budget - mem
            if self.check_memory and headroom <= 0:
                stats.pruned_memory += 1
                entries.append(SearchEntry(
                    strat, float("inf"), 0.0, 1.0, False, "OOM",
                    cluster=cluster.name, mem_bytes=mem,
                    hbm_headroom=headroom))
                continue

            provider = self._provider(cluster)
            sim = DistSim(self.cfg, strat, global_batch, seq, provider)
            positions = sim.positions()
            if self.prune and best_bt is not None:
                lb = work_lower_bound(positions, strat, provider)
                if lb >= best_bt:
                    # batch_time holds a LOWER BOUND, not a prediction;
                    # feasible=False keeps bounds out of naive
                    # `[e for e in entries if e.feasible]` rankings
                    stats.pruned_bound += 1
                    entries.append(SearchEntry(
                        strat, lb, 0.0, 0.0, False, "bound", pruned=True,
                        cluster=cluster.name, mem_bytes=mem,
                        hbm_headroom=headroom))
                    if not self.share_cache:
                        stats.provider_evaluations += \
                            provider.stats.evaluations
                        stats.cache_hits += provider.stats.hits
                    continue

            res = sim.simulate(positions=positions)
            stats.evaluated += 1
            bt = res.batch_time
            ptime = sum(provider.cached_time(e)
                        for e in stage_event_set(positions))
            entries.append(SearchEntry(
                strat, bt, 1.0 / bt if bt else 0.0,
                float(res.bubble_fraction()[0]), True,
                cluster=cluster.name, mem_bytes=mem,
                hbm_headroom=headroom, profile_time_s=ptime))
            if best_bt is None or bt < best_bt:
                best_bt = bt
            if not self.share_cache:
                stats.provider_evaluations += provider.stats.evaluations
                stats.cache_hits += provider.stats.hits
        return entries

    def _search_cluster_megabatch(self, cluster: ClusterSpec,
                                  grid: List[Candidate],
                                  global_batch: int, seq: int,
                                  stats: SearchStats) -> List[SearchEntry]:
        """Array-call variant of :meth:`_search_cluster`.

        Phase 1 applies the memory mask and compiles every surviving
        candidate's engine from the cluster's BuildCache; phase 2 is a
        single :class:`~repro_torch.core.megabatch.MegaBatch` evaluation;
        phase 3 replays the bound-pruning decisions in grid order over
        the vectorized batch times. Because the mega-batch times are
        bit-identical to per-engine predicts, the sequential prune
        trajectory (lower bound vs best-so-far) — and hence every
        entry — reproduces the per-cell path exactly.
        """
        from repro_torch.core.megabatch import MegaBatch

        provider = self.cache.provider(cluster)
        bcache = self.cache.build_cache(cluster)
        budget = cluster.chip.hbm_bytes * HBM_BUDGET

        rows = []        # (cand, mem, headroom, lane | None, lb | None)
        engines = []
        for cand in grid:
            stats.candidates += 1
            strat = cand.strategy
            mem = estimate_memory(self.cfg, strat, cand.microbatch, seq)
            headroom = budget - mem
            if self.check_memory and headroom <= 0:
                stats.pruned_memory += 1
                rows.append((cand, mem, headroom, None, None))
                continue
            eng = bcache.engine_for_cfg(self.cfg, strat, global_batch,
                                        seq)
            lb = (work_lower_bound(eng.build.stages, strat, provider)
                  if self.prune else None)
            rows.append((cand, mem, headroom, len(engines), lb))
            engines.append(eng)

        times = None
        bubbles = None
        if engines:
            # engines come from the BuildCache, so the identity tuple is
            # stable across repeat searches — a warm search reuses the
            # compiled array program and pays only the eval
            key = (cluster.name, tuple(id(e) for e in engines))
            mb = self._megabatch_programs.get(key)
            if mb is None:
                mb = MegaBatch(engines, device=self.device)
                self._megabatch_programs[key] = mb
                while len(self._megabatch_programs) > 8:
                    self._megabatch_programs.popitem(last=False)
            pred = mb.predict(self.megabatch_backend)
            times, bubbles = pred.batch_times, pred.bubble_fractions
            stats.megabatch_lanes += len(engines)

        entries: List[SearchEntry] = []
        best_bt: Optional[float] = None
        for cand, mem, headroom, lane, lb in rows:
            strat = cand.strategy
            if lane is None:
                entries.append(SearchEntry(
                    strat, float("inf"), 0.0, 1.0, False, "OOM",
                    cluster=cluster.name, mem_bytes=mem,
                    hbm_headroom=headroom))
                continue
            if self.prune and best_bt is not None and lb >= best_bt:
                stats.pruned_bound += 1
                entries.append(SearchEntry(
                    strat, lb, 0.0, 0.0, False, "bound", pruned=True,
                    cluster=cluster.name, mem_bytes=mem,
                    hbm_headroom=headroom))
                continue
            bt = float(times[lane])
            stats.evaluated += 1
            ptime = sum(provider.cached_time(e)
                        for e in stage_event_set(
                            engines[lane].build.stages))
            entries.append(SearchEntry(
                strat, bt, 1.0 / bt if bt else 0.0,
                float(bubbles[lane]), True,
                cluster=cluster.name, mem_bytes=mem,
                hbm_headroom=headroom, profile_time_s=ptime))
            if best_bt is None or bt < best_bt:
                best_bt = bt
        return entries
