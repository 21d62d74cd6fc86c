"""Content-addressed build cache for the accuracy sweep (tentpole of
the sweep-scale subsystem).

The paper's unique-event dedup (Observation 1) makes *profiling* cheap,
but the sweep was still rebuilding the per-cell model graph
(``build_positions``) and the engine's event-mean precomputation for
every cell — the dominant cost of small validation cells. Those builds
are pure functions of ``(arch, smoke, strategy, microbatch, seq,
cluster)``, and large parts of the key collapse further:

* **positions** depend only on (arch, smoke, mp, pp·vpp, microbatch,
  seq, cluster) — not on dp, schedule or the microbatch *count*;
* the **engine build** (:class:`repro_torch.core.engine.EngineBuild` — event
  means, p2p/DP-sync/optimizer means) additionally depends on dp /
  zero1 / grad_compress but still NOT on the pipeline schedule or
  microbatch count: a schedule only reorders tasks over the same
  stage/event structure (verified bit-identical in
  ``tests/test_sweep_scale.py``), so the full matrix — where each
  (model, strategy) pair recurs across 4 schedules — shares one build
  across the same-vpp schedules of each pair (gpipe/1f1b/pipedream;
  interleaved's vpp=2 builds its own position structure);
* the **engine** itself (schedule task lists over a build) is cached on
  the full key, so re-sweeping with a warm cache skips everything.

Cached sweeps are bit-identical to uncached ones: every number the
engine consumes is the same profiled float either way. The cache is
bound to one provider and self-invalidates when that provider's event
cache is cleared (``Provider.cache_version``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, get_config, smoke_config
from repro_torch.core.engine import EngineBuild, EventFlowEngine
from repro_torch.core.events import Stage, Strategy
from repro_torch.core.hierarchy import build_positions
from repro_torch.core.profiler import Provider
from repro_torch.core.scenario import TRAIN, Scenario


@dataclasses.dataclass
class BuildCacheStats:
    """Hit/miss accounting per cache level (reported by
    ``benchmarks/bench_validate.py``)."""
    positions_hits: int = 0
    positions_misses: int = 0
    build_hits: int = 0
    build_misses: int = 0
    engine_hits: int = 0
    engine_misses: int = 0
    invalidations: int = 0

    @property
    def hits(self) -> int:
        return self.positions_hits + self.build_hits + self.engine_hits

    @property
    def misses(self) -> int:
        return (self.positions_misses + self.build_misses
                + self.engine_misses)

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def merge(self, other: "BuildCacheStats") -> None:
        """Accumulate a worker shard's accounting (parallel executor)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


def _strip_schedule(strat: Strategy) -> Strategy:
    """The strategy modulo schedule + microbatch count — the part an
    :class:`EngineBuild` actually depends on."""
    return dataclasses.replace(strat, schedule="", microbatches=1)


class BuildCache:
    """Per-provider cache of positions / engine builds / engines.

    All keys are content-addressed (arch name + smoke flag + frozen
    ``Strategy`` + derived microbatch + seq); the cluster is implied by
    the bound provider. Use one cache per sweep (or per worker shard —
    see :mod:`repro_torch.validate.executor`).
    """

    def __init__(self, provider: Provider):
        self.provider = provider
        self._positions: Dict[Tuple, List[Stage]] = {}
        self._builds: Dict[Tuple, EngineBuild] = {}
        self._engines: Dict[Tuple, EventFlowEngine] = {}
        self._version = provider.cache_version
        self.stats = BuildCacheStats()

    # ------------------------------------------------------------------

    def _check_version(self) -> None:
        """Everything cached here bakes in provider event means — a
        provider cache clear invalidates all three levels at once."""
        if self._version != self.provider.cache_version:
            self._positions.clear()
            self._builds.clear()
            self._engines.clear()
            self._version = self.provider.cache_version
            self.stats.invalidations += 1

    @staticmethod
    def _microbatch(strat: Strategy, global_batch: int,
                    scenario: Scenario = TRAIN) -> int:
        # delegate to the ONE shared derivation (Scenario → Strategy)
        # so this cache key can never drift from DistSim.microbatch()
        return scenario.microbatch_size(strat, global_batch)

    @staticmethod
    def _resolve(arch: str, smoke: bool) -> ArchConfig:
        cfg = get_config(arch)
        return smoke_config(cfg) if smoke else cfg

    # ---- cfg-object-keyed surface (search engine / mega-batch) ----
    # ArchConfig is a frozen dataclass, so the config VALUE is the key:
    # callers that already hold a config (SearchEngine) skip the
    # registry entirely, and two arch names that resolve to an equal
    # config collapse to one entry.

    def positions_for(self, cfg: ArchConfig, strat: Strategy,
                      microbatch: int, seq: int,
                      scenario: Scenario = TRAIN) -> List[Stage]:
        self._check_version()
        sc = scenario.stripped()
        key = (cfg, strat.mp, strat.pp, strat.vpp, microbatch, seq, sc)
        hit = self._positions.get(key)
        if hit is not None:
            self.stats.positions_hits += 1
            return hit
        self.stats.positions_misses += 1
        pos = build_positions(cfg, strat, microbatch, seq,
                              self.provider.cluster, scenario=sc)
        self._positions[key] = pos
        return pos

    def build_for(self, cfg: ArchConfig, strat: Strategy,
                  microbatch: int, seq: int,
                  scenario: Scenario = TRAIN) -> EngineBuild:
        self._check_version()
        sc = scenario.stripped()
        key = (cfg, _strip_schedule(strat), microbatch, seq, sc)
        hit = self._builds.get(key)
        if hit is not None:
            self.stats.build_hits += 1
            return hit
        ext = self._build_fallback(key)
        if ext is not None:
            self._builds[key] = ext
            self.stats.build_hits += 1
            return ext
        self.stats.build_misses += 1
        pos = self.positions_for(cfg, strat, microbatch, seq, sc)
        # with_dp_sync=None: precompute sync means whenever dp > 1 so
        # pipedream and the syncing schedules share one build
        build = EngineBuild(pos, strat, self.provider, with_dp_sync=None,
                            scenario=sc)
        self._builds[key] = build
        self._build_created(key, build)
        return build

    # secondary-lookup hooks for subclasses backed by external storage
    # (repro_torch.store.PersistentBuildCache): a fallback hit counts as a
    # build hit, a freshly-computed build is offered for persisting.
    def _build_fallback(self, key: Tuple) -> Optional[EngineBuild]:
        return None

    def _build_created(self, key: Tuple, build: EngineBuild) -> None:
        pass

    def engine_for_cfg(self, cfg: ArchConfig, strat: Strategy,
                       global_batch: int, seq: int,
                       scenario: Scenario = TRAIN) -> EventFlowEngine:
        self._check_version()
        micro = self._microbatch(strat, global_batch, scenario)
        # engines key on the FULL scenario (decode step count/arrivals
        # are schedule-level); builds/positions on the stripped one
        key = (cfg, strat, micro, seq, scenario)
        hit = self._engines.get(key)
        if hit is not None:
            self.stats.engine_hits += 1
            return hit
        self.stats.engine_misses += 1
        build = self.build_for(cfg, strat, micro, seq, scenario)
        eng = EventFlowEngine(build.stages, strat, self.provider,
                              build=build, scenario=scenario)
        self._engines[key] = eng
        return eng

    # ---- registry-name surface (validation sweep cells) ----

    def positions(self, arch: str, smoke: bool, strat: Strategy,
                  microbatch: int, seq: int,
                  scenario: Scenario = TRAIN) -> List[Stage]:
        return self.positions_for(self._resolve(arch, smoke), strat,
                                  microbatch, seq, scenario)

    def build(self, arch: str, smoke: bool, strat: Strategy,
              microbatch: int, seq: int,
              scenario: Scenario = TRAIN) -> EngineBuild:
        return self.build_for(self._resolve(arch, smoke), strat,
                              microbatch, seq, scenario)

    def engine(self, arch: str, smoke: bool, strat: Strategy,
               global_batch: int, seq: int,
               scenario: Scenario = TRAIN) -> EventFlowEngine:
        return self.engine_for_cfg(self._resolve(arch, smoke), strat,
                                   global_batch, seq, scenario)

    def engine_for(self, cell) -> EventFlowEngine:
        """Engine for a :class:`repro_torch.validate.sweep.ValidationCell`."""
        return self.engine(cell.arch, cell.smoke, cell.strategy,
                           cell.global_batch, cell.seq,
                           getattr(cell, "scenario", TRAIN))

    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        """Accounting summary: per-level hits/misses + entry counts."""
        out = self.stats.to_dict()
        out.update(positions_entries=len(self._positions),
                   build_entries=len(self._builds),
                   engine_entries=len(self._engines))
        return out
