"""Simulator-as-a-service: strategy queries over a warm ProfileStore.

The production framing of the paper's unique-event dedup: a
capacity-planning service answering "(model, strategy, cluster) →
predicted batch time, memory headroom, utilization" at interactive
latency. All heavy state — profiled event times and engine builds —
comes from a shared :class:`~repro_torch.store.profile_store.ProfileStore`,
so a warm server performs ZERO provider evaluations (asserted in
``tests/test_store.py``); queries only pay schedule construction and
one array evaluation.

The batch path scores every queried strategy of a cluster in ONE
:class:`~repro_torch.core.megabatch.MegaBatch` array call, so answering a
thousand queries costs one padded ``(steps, K)`` program per cluster —
batch times stay bit-identical to per-query ``DistSim.simulate()``.

    server = DistSim.serve("/var/distsim/store")
    ans = server.answer(ServeQuery("gpt2_345m", Strategy(pp=2, dp=2,
                                   microbatches=4)))
    answers = server.answer_batch(queries)      # mega-batch scored
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.costmodel import CLUSTERS, H100_CLUSTER, ClusterSpec
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.events import Strategy
from repro_torch.core.megabatch import MegaBatch
from repro_torch.core.modelgraph import kv_cache_bytes
from repro_torch.core.profiler import provider_for
from repro_torch.core.scenario import TRAIN, Scenario, scenario_from_dict
from repro_torch.search.prune import HBM_BUDGET, estimate_memory
from repro_torch.store.persistent import PersistentBuildCache
from repro_torch.store.profile_store import ProfileStore, open_store


@dataclasses.dataclass(frozen=True)
class ServeQuery:
    """One capacity-planning question — training by default, serving
    when ``scenario`` is a :class:`~repro_torch.core.scenario.Prefill` or
    :class:`~repro_torch.core.scenario.Decode` (then ``global_batch`` is the
    concurrent request count and tokens/sec is decode throughput)."""
    arch: str
    strategy: Strategy
    global_batch: int = 16
    seq: int = 512
    smoke: bool = False                    # reduce arch via smoke_config
    cluster: str = H100_CLUSTER.name      # registry name
    scenario: Scenario = TRAIN
    # degraded-fleet what-if: a straggler plane applied at predict
    # time (run-level only — builds/store addresses never key on it).
    # The perturbation module is not ported yet: the field keeps its
    # place and anything but None raises (it is never ignored).
    perturb: Optional[object] = None

    def __post_init__(self):
        if self.perturb is not None:
            raise NotImplementedError(
                "ServeQuery(perturb=...) needs repro_torch.core.perturb, "
                "which is not ported yet; pass perturb=None")

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["strategy"] = self.strategy.to_dict()
        d["scenario"] = self.scenario.to_dict()
        # the scenario-key pattern: an absent axis is OMITTED, so every
        # pre-perturb serialized query/report stays byte-identical
        del d["perturb"]
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ServeQuery":
        d = dict(d)
        d["strategy"] = Strategy.from_dict(d["strategy"])
        d["scenario"] = scenario_from_dict(d.get("scenario"))
        if d.get("perturb") is not None:
            raise NotImplementedError(
                "a serialized perturbation needs repro_torch.core.perturb, "
                "which is not ported yet")
        d["perturb"] = None
        from repro_torch.core.serde import dataclass_from_dict
        return dataclass_from_dict(cls, d)


@dataclasses.dataclass
class ServeAnswer:
    """The service's reply: predicted iteration economics + memory."""
    query: ServeQuery
    batch_time: float           # bit-identical to DistSim.simulate()
    throughput_iters: float
    throughput_tokens: float
    mem_bytes: float            # estimated per-device HBM footprint
    hbm_headroom: float         # budgeted HBM minus footprint
    feasible: bool              # fits in the HBM budget
    utilization_mean: float     # mean busy fraction across devices
    bubble_fraction: float
    kv_cache_bytes: float = 0.0  # per-device KV/SSM state (decode only)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["query"] = self.query.to_dict()
        return d


class StrategyServer:
    """Query front-end over one store (``DistSim.serve(store)``).

    Holds one provider + :class:`PersistentBuildCache` per cluster
    (created lazily on first query for that cluster, which loads the
    persisted events). Repeat queries reuse in-memory engines and the
    compiled mega-batch program; newly-profiled events (cold entries)
    are flushed back to the store after every batch, so the store warms
    monotonically under live traffic.

    ``device`` is where the mega-batch programs are evaluated: the card
    by default (an error when there is none), the CPU only when the
    caller passes ``device="cpu"``. ``provider_factory`` defaults to
    :func:`repro_torch.core.profiler.provider_for`, which gives each
    cluster the analytical provider of its chip.
    """

    _PROGRAM_MEMO_MAX = 8

    def __init__(self, store, clusters: Optional[Sequence[ClusterSpec]]
                 = None, provider_factory=provider_for,
                 backend: str = "auto", device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.store: ProfileStore = open_store(store)
        specs = list(clusters) if clusters is not None \
            else list(CLUSTERS.values())
        self.clusters: Dict[str, ClusterSpec] = {c.name: c for c in specs}
        self.provider_factory = provider_factory
        self.backend = backend
        self._caches: Dict[str, PersistentBuildCache] = {}
        self._programs: "OrderedDict" = OrderedDict()
        self.queries_answered = 0
        #: compiled programs served from the memo instead of recompiled
        self.programs_reused = 0

    # ---- plumbing ----

    def _cache_for(self, cluster_name: str) -> PersistentBuildCache:
        bc = self._caches.get(cluster_name)
        if bc is None:
            try:
                spec = self.clusters[cluster_name]
            except KeyError:
                raise ValueError(
                    f"unknown cluster {cluster_name!r}; served: "
                    f"{sorted(self.clusters)}") from None
            bc = PersistentBuildCache(self.provider_factory(spec),
                                      self.store)
            self._caches[cluster_name] = bc
        return bc

    @staticmethod
    def _resolve_cfg(q: ServeQuery):
        cfg = get_config(q.arch)
        return smoke_config(cfg) if q.smoke else cfg

    # ---- the query surface ----

    def answer(self, query: ServeQuery) -> ServeAnswer:
        return self.answer_batch([query])[0]

    def answer_batch(self, queries: Sequence[ServeQuery]
                     ) -> List[ServeAnswer]:
        """Answer all queries, one mega-batch array call per distinct
        (cluster, perturbation) group, answers returned in query
        order. Perturbed queries share the unperturbed queries'
        engines and store entries — only the compiled program differs
        (the straggler plane scales profiled means at compile time)."""
        queries = list(queries)
        by_group: "OrderedDict" = OrderedDict()
        for i, q in enumerate(queries):
            by_group.setdefault((q.cluster, q.perturb), []).append(i)

        answers: List[Optional[ServeAnswer]] = [None] * len(queries)
        for (cname, perturb), idxs in by_group.items():
            bc = self._cache_for(cname)
            spec = self.clusters[cname]
            budget = spec.chip.hbm_bytes * HBM_BUDGET
            engines = []
            meta = []
            for i in idxs:
                q = queries[i]
                cfg = self._resolve_cfg(q)
                sc = q.scenario
                micro = sc.microbatch_size(q.strategy, q.global_batch)
                mem = estimate_memory(cfg, q.strategy, micro, q.seq, sc)
                kv = 0.0
                if sc.kind == "decode":
                    kv = kv_cache_bytes(cfg, micro, sc.kv_len(q.seq)) \
                        / (q.strategy.mp * q.strategy.pp)
                eng = bc.engine_for_cfg(cfg, q.strategy,
                                        q.global_batch, q.seq, sc)
                meta.append((i, q, mem, budget - mem, kv))
                engines.append(eng)

            # engine objects are stable across repeat queries (the
            # build cache returns incumbents), so a repeat batch reuses
            # the compiled program and pays only the array eval
            key = (cname, perturb, tuple(id(e) for e in engines))
            mb = self._programs.get(key)
            if mb is not None:
                self.programs_reused += 1
            else:
                mb = MegaBatch(engines, perturb=perturb,
                               device=self.device)
                self._programs[key] = mb
                while len(self._programs) > self._PROGRAM_MEMO_MAX:
                    self._programs.popitem(last=False)
            pred = mb.predict(self.backend)

            for lane, (i, q, mem, headroom, kv) in enumerate(meta):
                bt = float(pred.batch_times[lane])
                bubble = float(pred.bubble_fractions[lane])
                answers[i] = ServeAnswer(
                    query=q, batch_time=bt,
                    throughput_iters=1.0 / bt if bt else 0.0,
                    throughput_tokens=(
                        q.scenario.tokens(q.global_batch, q.seq) / bt
                        if bt else 0.0),
                    mem_bytes=mem, hbm_headroom=headroom,
                    feasible=headroom > 0,
                    utilization_mean=1.0 - bubble,
                    bubble_fraction=bubble, kv_cache_bytes=kv)
            bc.flush()          # persist any cold-profiled events
        self.queries_answered += len(queries)
        assert all(a is not None for a in answers)
        return answers

    # ---- accounting ----

    def snapshot(self) -> Dict:
        """Per-cluster provider + build-cache accounting, plus store
        stats — the 'zero evaluations on a warm store' evidence."""
        out: Dict = {"queries_answered": self.queries_answered,
                     "programs_reused": self.programs_reused,
                     "store": self.store.snapshot(), "clusters": {}}
        for name, bc in self._caches.items():
            ps = bc.provider.stats
            out["clusters"][name] = {
                "evaluations": ps.evaluations, "hits": ps.hits,
                "unique_events": bc.provider.cache_size,
                "builds": bc.stats.to_dict(),
            }
        return out
