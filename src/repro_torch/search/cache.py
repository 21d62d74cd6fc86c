"""Shared profile/event cache for strategy search.

The paper's core trick (Observation 1): events are identical across
devices, microbatches — and, crucially for search, across *candidate
strategies*. Two strategies with the same MP degree share every layer
compute event; collectives recur across grid points. A ``ProfileCache``
holds one profiling provider per target cluster and is shared by every
candidate the engine scores, so each unique event is cost-evaluated
once per search instead of once per candidate.

Event identity is structural (``Event`` is a frozen dataclass keyed on
kind/op/sharded shapes/participants/scope), so the provider's dict
cache IS the unique-event signature cache.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping

from repro_torch.core.costmodel import ClusterSpec
from repro_torch.core.profiler import Provider, provider_for


class ProfileCache:
    """One provider (and thus one event-time cache) per cluster; by
    default the analytical provider of each cluster's chip
    (:func:`repro_torch.core.profiler.provider_for`).

    Pass ``store`` (a :class:`repro_torch.store.ProfileStore` or path) to
    persist the dedup layer across search invocations: per-cluster
    build caches become :class:`repro_torch.store.PersistentBuildCache`\\ s,
    so a fresh process re-running the same search loads the profiled
    events + engine builds from disk instead of re-deriving them."""

    def __init__(self, providers: Mapping[str, Provider], store=None):
        self.providers: Dict[str, Provider] = dict(providers)
        self.store = store
        self._build_caches: Dict[str, object] = {}

    @classmethod
    def for_clusters(cls, clusters: Iterable[ClusterSpec],
                     provider_factory: Callable[[ClusterSpec], Provider]
                     = provider_for, store=None) -> "ProfileCache":
        return cls({c.name: provider_factory(c) for c in clusters},
                   store=store)

    @classmethod
    def from_provider(cls, provider: Provider,
                      store=None) -> "ProfileCache":
        return cls({provider.cluster.name: provider}, store=store)

    def provider(self, cluster: ClusterSpec) -> Provider:
        return self.providers[cluster.name]

    def build_cache(self, cluster: ClusterSpec):
        """Per-cluster :class:`repro_torch.validate.build_cache.BuildCache`
        bound to that cluster's provider — the positions/build/engine
        dedup layer the mega-batch search path compiles from. Persists
        with this ProfileCache, so repeat searches reuse engines (and
        profile nothing). Imported lazily: repro_torch.validate pulls in the
        sweep stack, which search-only callers don't need."""
        bc = self._build_caches.get(cluster.name)
        if bc is None:
            if self.store is not None:
                from repro_torch.store.persistent import PersistentBuildCache
                bc = PersistentBuildCache(self.provider(cluster),
                                          self.store)
            else:
                from repro_torch.validate.build_cache import BuildCache
                bc = BuildCache(self.provider(cluster))
            self._build_caches[cluster.name] = bc
        return bc

    def flush(self) -> int:
        """Persist newly-profiled events of every store-backed build
        cache (no-op without a store). Returns events written."""
        n = 0
        for bc in self._build_caches.values():
            if hasattr(bc, "flush"):
                n += bc.flush()
        return n

    @property
    def clusters(self) -> list:
        return [p.cluster for p in self.providers.values()]

    # ---- aggregate accounting across clusters ----
    @property
    def evaluations(self) -> int:
        return sum(p.stats.evaluations for p in self.providers.values())

    @property
    def hits(self) -> int:
        return sum(p.stats.hits for p in self.providers.values())

    @property
    def unique_events(self) -> int:
        return sum(p.cache_size for p in self.providers.values())

    def reset_stats(self) -> None:
        for p in self.providers.values():
            p.stats.reset()

    def snapshot(self) -> Dict[str, float]:
        lookups = self.evaluations + self.hits
        return {
            "unique_events": self.unique_events,
            "evaluations": self.evaluations,
            "hits": self.hits,
            "hit_rate": self.hits / lookups if lookups else 0.0,
        }
