"""DistSim top-level API (paper Fig. 6).

    sim = DistSim(cfg, strategy, global_batch=16, seq=512)
    pred = sim.simulate()                 # the model: zero-noise predict
    reps = sim.simulate(seeds=(0, 1, 2))  # discrete-event replay oracle

One entry point: :meth:`DistSim.simulate` returns a uniform
:class:`SimBatch` — the predict lane when ``seeds is None`` (the
paper's construction: each unique event's profiled mean used once), a
batched replay when seeds are given (every per-device event instance
with profiling jitter, straggler and clock effects — our stand-in for
the real 16-GPU cluster, see DESIGN.md §2). The store-served query
front-end (:meth:`DistSim.serve` / :meth:`DistSim.serve_batch`) scores
batches of strategies on the card through the mega-batch kernel.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.costmodel import H100_CLUSTER
from repro_torch.core.engine import EventFlowEngine
from repro_torch.core.events import (Stage, Strategy, build_stage_events,
                               stage_signature, unique_events)
from repro_torch.core.hierarchy import build_positions
from repro_torch.core.profiler import (Provider, profile_events,
                                       profiling_cost, provider_for)
from repro_torch.core.scenario import TRAIN, Scenario
from repro_torch.core.timeline import Timeline, TimelineBatch


@dataclasses.dataclass
class SimResult:
    timeline: Timeline
    batch_time: float
    throughput_iters: float
    throughput_tokens: float
    utilization: Dict[int, float]
    bubble_fraction: float


def _to_result(tl: Timeline, global_batch: int, seq: int,
               scenario: Scenario = TRAIN) -> SimResult:
    bt = tl.batch_time
    util = tl.utilization()
    return SimResult(
        timeline=tl,
        batch_time=bt,
        throughput_iters=1.0 / bt if bt else 0.0,
        throughput_tokens=(scenario.tokens(global_batch, seq) / bt
                           if bt else 0),
        utilization=util,
        bubble_fraction=tl.bubble_fraction(util),
    )


class SimBatch:
    """Uniform result of :meth:`DistSim.simulate`.

    Wraps the engine's array-native :class:`TimelineBatch` (one lane
    per seed; a single zero-noise lane for predict) plus the sim's
    workload scalars, so both modes expose the same accessors:

    * arrays across lanes: :attr:`batch_times`,
      :meth:`throughput_iters`, :meth:`bubble_fraction`,
      :meth:`utilization`;
    * per-lane views: :meth:`timeline`, :meth:`result`,
      :meth:`results` (lazy — no ``Activity`` list is built until a
      timeline is inspected);
    * scalar convenience for the single-lane case:
      :attr:`batch_time` (raises on multi-seed batches rather than
      silently picking a lane).
    """

    def __init__(self, batch: TimelineBatch, global_batch: int, seq: int,
                 mode: str, scenario: Scenario = TRAIN):
        self.batch = batch
        self.global_batch = global_batch
        self.seq = seq
        self.mode = mode                       # "predict" | "replay"
        self.scenario = scenario

    def __len__(self) -> int:
        return len(self.batch)

    def __repr__(self) -> str:
        return (f"SimBatch(mode={self.mode!r}, lanes={len(self)}, "
                f"seeds={self.seeds})")

    @property
    def seeds(self) -> List[Optional[int]]:
        return list(self.batch.seeds)

    @property
    def batch_times(self) -> np.ndarray:
        return self.batch.batch_times

    @property
    def batch_time(self) -> float:
        """The single lane's batch time; ambiguous (and an error) when
        the batch holds several seeds."""
        if len(self) != 1:
            raise ValueError(
                f"batch_time is ambiguous on a {len(self)}-lane "
                f"SimBatch; use .batch_times or .result(i)")
        return float(self.batch.batch_times[0])

    def throughput_iters(self) -> np.ndarray:
        # out= zeros: without it np.divide(..., where=) leaves the
        # masked entries as uninitialized memory, which np.where then
        # multiplies — NaN/Inf garbage could poison the 0.0 branch
        bt = self.batch.batch_times
        return np.divide(1.0, bt, out=np.zeros_like(bt), where=bt > 0)

    def throughput_tokens(self) -> np.ndarray:
        """Tokens/sec per lane — scenario-aware numerator (train and
        prefill push ``global_batch * seq`` tokens per iteration;
        decode produces one token per slot per autoregressive step)."""
        return (self.throughput_iters()
                * self.scenario.tokens(self.global_batch, self.seq))

    def utilization(self) -> np.ndarray:
        """(lanes, n_devices) busy fractions."""
        return self.batch.utilization()

    def bubble_fraction(self) -> np.ndarray:
        return self.batch.bubble_fraction()

    def timeline(self, i: int = 0) -> Timeline:
        return self.batch.timeline(i)

    def result(self, i: int = 0) -> SimResult:
        """Lane ``i`` as the classic :class:`SimResult`."""
        return _to_result(self.batch.timeline(i), self.global_batch,
                          self.seq, self.scenario)

    def results(self) -> List[SimResult]:
        return [self.result(i) for i in range(len(self))]


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"DistSim.{old}() is deprecated; use DistSim.{new}",
        DeprecationWarning, stacklevel=3)


class DistSim:
    def __init__(self, cfg: ArchConfig, strategy: Strategy,
                 global_batch: int, seq: int,
                 provider: Optional[Provider] = None,
                 scenario: Scenario = TRAIN):
        self.cfg = cfg
        self.strategy = strategy
        self.global_batch = global_batch
        self.seq = seq
        self.provider = provider or provider_for(H100_CLUSTER)
        self.scenario = scenario
        # one cached engine per scenario actually simulated, plus one
        # slot for caller-provided positions
        self._engines: Dict[Scenario, EventFlowEngine] = {}
        self._engine: Optional[EventFlowEngine] = None
        self._engine_key = None
        if scenario.kind == "decode":
            if global_batch % strategy.dp:
                raise ValueError(
                    f"global_batch {global_batch} (decode slots) not "
                    f"divisible by dp = {strategy.dp}")
        elif global_batch % (strategy.dp * strategy.microbatches):
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"dp*microbatches = {strategy.dp * strategy.microbatches}")

    # ---- the one simulation surface ----
    def simulate(self, seeds: Union[int, Sequence[int], None] = None,
                 jitter_sigma: float = 0.025,
                 straggler_sigma: float = 0.0,
                 clock_sigma: float = 0.0,
                 positions: Optional[List[Stage]] = None,
                 scenario: Optional[Scenario] = None,
                 perturb=None):
        """Run the model once, uniformly.

        ``seeds=None`` (default) is the performance model: one
        zero-noise predict lane (the sigma arguments are ignored —
        predict is deterministic by construction). An int or sequence
        of ints replays the discrete-event oracle once per seed, all
        lanes evaluated in one vectorized pass, bit-identical per seed
        to the historical sequential ``replay(seed=s)`` calls.

        ``scenario`` overrides the sim's constructor scenario for this
        call (e.g. ``sim.simulate(scenario=Decode(steps=16))`` on a sim
        built for training).

        ``perturb`` (a :class:`repro_torch.core.perturb.Perturbation`)
        models a degraded fleet — straggler slowdowns and injected
        failures with checkpoint-restore recovery — and returns a
        :class:`repro_torch.core.perturb.DegradedRun` (a multi-step
        spliced timeline) instead of a single-step :class:`SimBatch`.
        ``perturb=None`` is the byte-identical unperturbed path.
        """
        if perturb is not None:
            if scenario is not None or positions is not None:
                raise ValueError(
                    "perturb composes a multi-step run over the sim's "
                    "own scenario/positions; per-call overrides are "
                    "not supported together")
            from repro_torch.core.perturb import simulate_degraded
            return simulate_degraded(
                self, perturb, seeds=seeds, jitter_sigma=jitter_sigma,
                straggler_sigma=straggler_sigma, clock_sigma=clock_sigma)
        sc = self.scenario if scenario is None else scenario
        engine = self.engine(positions, scenario=sc)
        if seeds is None:
            return SimBatch(engine.run_batched(None), self.global_batch,
                            self.seq, "predict", sc)
        if isinstance(seeds, (int, np.integer)):
            seeds = [int(seeds)]
        batch = engine.run_batched(
            list(seeds), jitter_sigma=jitter_sigma,
            straggler_sigma=straggler_sigma, clock_sigma=clock_sigma)
        return SimBatch(batch, self.global_batch, self.seq, "replay", sc)

    # ---- deprecated 5-method surface (thin delegating wrappers) ----
    def predict(self, positions: Optional[List[Stage]] = None) -> SimResult:
        """Deprecated: use ``simulate(positions=...).result()``."""
        _deprecated("predict", "simulate(positions=...).result()")
        return self.simulate(positions=positions).result()

    def replay(self, seed: int = 0, jitter_sigma: float = 0.025,
               straggler_sigma: float = 0.0,
               clock_sigma: float = 0.0,
               positions: Optional[List[Stage]] = None) -> SimResult:
        """Deprecated: use ``simulate(seeds=seed, ...).result()``."""
        _deprecated("replay", "simulate(seeds=..., ...).result()")
        return self.simulate(
            seeds=seed, jitter_sigma=jitter_sigma,
            straggler_sigma=straggler_sigma, clock_sigma=clock_sigma,
            positions=positions).result()

    def predict_batched(self, positions: Optional[List[Stage]] = None
                        ) -> TimelineBatch:
        """Deprecated: use ``simulate(positions=...).batch``."""
        _deprecated("predict_batched", "simulate(positions=...).batch")
        return self.simulate(positions=positions).batch

    def replay_batched(self, seeds, jitter_sigma: float = 0.025,
                       straggler_sigma: float = 0.0,
                       clock_sigma: float = 0.0,
                       positions: Optional[List[Stage]] = None
                       ) -> TimelineBatch:
        """Deprecated: use ``simulate(seeds=..., ...).batch``."""
        _deprecated("replay_batched", "simulate(seeds=..., ...).batch")
        return self.simulate(
            seeds=list(seeds), jitter_sigma=jitter_sigma,
            straggler_sigma=straggler_sigma, clock_sigma=clock_sigma,
            positions=positions).batch

    def predict_and_replay(self, seeds=(0,), jitter_sigma: float = 0.025,
                           straggler_sigma: float = 0.0,
                           clock_sigma: float = 0.0, batched: bool = True):
        """Deprecated: call ``simulate()`` twice (predict lane + replay
        lanes); for the sequential differential baseline drive
        ``engine().run(seed=...)`` directly."""
        _deprecated("predict_and_replay",
                    "simulate() / simulate(seeds=...)")
        engine = self.engine()
        pred = _to_result(engine.run(), self.global_batch, self.seq)
        if batched:
            batch = engine.run_batched(list(seeds),
                                       jitter_sigma=jitter_sigma,
                                       straggler_sigma=straggler_sigma,
                                       clock_sigma=clock_sigma)
            replays = [_to_result(batch.timeline(i), self.global_batch,
                                  self.seq) for i in range(len(batch))]
        else:
            replays = [_to_result(engine.run(
                jitter_sigma=jitter_sigma,
                straggler_sigma=straggler_sigma,
                clock_sigma=clock_sigma, seed=s), self.global_batch,
                self.seq) for s in seeds]
        return pred, replays

    # ---- store-served query front-end ----
    @classmethod
    def serve(cls, store, clusters=None, **kwargs):
        """A :class:`repro_torch.store.StrategyServer` over a warm
        :class:`repro_torch.store.ProfileStore`: answers "(model, strategy,
        cluster) -> predicted batch time / memory headroom /
        utilization" queries at interactive latency (persisted events +
        engine builds; no re-profiling on a warm store). Keyword
        arguments go to the server: ``device`` (the card by default;
        ``"cpu"`` only when the caller asks), ``backend``,
        ``provider_factory``."""
        from repro_torch.store.serve import StrategyServer
        return StrategyServer(store, clusters=clusters, **kwargs)

    @classmethod
    def serve_batch(cls, queries, store, clusters=None, **kwargs):
        """One-shot batch query: build a server over ``store`` and
        answer ``queries`` (a sequence of
        :class:`repro_torch.store.ServeQuery`) via ONE mega-batch array call
        per queried cluster. Returns ``List[ServeAnswer]`` in query
        order; batch times are bit-identical to per-query
        ``simulate()``."""
        return cls.serve(store, clusters=clusters, **kwargs) \
            .answer_batch(queries)

    # ---- search-engine hooks ----
    def microbatch(self, scenario: Optional[Scenario] = None) -> int:
        sc = self.scenario if scenario is None else scenario
        return sc.microbatch_size(self.strategy, self.global_batch)

    def positions(self, scenario: Optional[Scenario] = None) -> List[Stage]:
        """Pipeline positions (pp*vpp stages) with composed fwd/bwd
        events — precompute once, pass to simulate() and the search
        pruner so candidates don't rebuild the model graph."""
        sc = self.scenario if scenario is None else scenario
        return build_positions(self.cfg, self.strategy,
                               self.microbatch(sc), self.seq,
                               self.provider.cluster, scenario=sc)

    def engine(self, positions: Optional[List[Stage]] = None,
               scenario: Optional[Scenario] = None) -> EventFlowEngine:
        """Event-flow engine for this sim. Reused across simulate()
        calls (one slot per scenario for the default positions build,
        one keyed on the caller's positions) so the per-strategy
        schedule + event-mean precomputation runs once per positions
        set.

        Explicit positions are keyed on STRUCTURAL content
        (:func:`repro_torch.core.events.stage_signature`), not list identity:
        an equal-content list reuses the cached engine, and a
        mutated-then-reused list rebuilds instead of silently returning
        stale times. Either slot also rebuilds when the provider's
        event cache was cleared since the engine baked in its means."""
        sc = self.scenario if scenario is None else scenario
        if positions is None:
            cached = self._engines.get(sc)
            if cached is None or self._stale(cached):
                cached = EventFlowEngine(
                    self.positions(sc), self.strategy, self.provider,
                    scenario=sc)
                self._engines[sc] = cached
            return cached
        key = (sc, stage_signature(positions))
        if (self._engine is None or self._engine_key != key
                or self._stale(self._engine)):
            self._engine = EventFlowEngine(positions, self.strategy,
                                           self.provider, scenario=sc)
            self._engine_key = key
        return self._engine

    def use_engine(self, engine: EventFlowEngine) -> None:
        """Adopt a prebuilt default engine (the validate sweep's
        :class:`~repro_torch.validate.build_cache.BuildCache` hands sims
        cached engines so per-cell simulate() skips the build). The
        engine is slotted under ITS scenario, so a serving engine and
        a training engine can both be adopted on one sim."""
        if engine.provider is not self.provider:
            raise ValueError("engine was built against a different "
                             "provider than this sim's")
        self._engines[engine.scenario] = engine

    def _stale(self, engine: EventFlowEngine) -> bool:
        return engine.cache_version != self.provider.cache_version

    def _result(self, tl: Timeline) -> SimResult:
        return _to_result(tl, self.global_batch, self.seq, self.scenario)

    # ---- Table 3 accounting ----
    def profiling_report(self) -> Dict[str, float]:
        micro = self.microbatch()     # shared floor — paths can't drift
        stages = build_stage_events(self.cfg, self.strategy, micro, self.seq,
                                    self.provider.cluster.devices_per_island)
        counts = unique_events(stages, self.strategy,
                               self.provider.cluster.devices_per_island)
        profile = profile_events(counts.keys(), self.provider)
        return profiling_cost(counts, profile)
