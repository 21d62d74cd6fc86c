"""Store-backed build cache: the in-process dedup layer made durable.

``PersistentBuildCache`` extends :class:`repro_torch.validate.BuildCache`
with a :class:`~repro_torch.store.profile_store.ProfileStore` behind it:

* on construction, persisted event times are merged into the bound
  provider (so every subsequent ``provider.time()`` is a hit — zero
  re-profiling on a warm store);
* a build-cache miss consults the store before computing; a computed
  build is persisted immediately (atomic, content-addressed);
* :meth:`flush` writes the provider's newly-profiled events back.

Served results are bit-identical to cold in-process runs: event floats
round-trip exactly through JSON repr, builds round-trip exactly through
pickle, and the engine layer on top is byte-for-byte the same code.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.engine import EngineBuild
from repro_torch.core.profiler import Provider
from repro_torch.store.profile_store import ProfileStore, open_store
from repro_torch.validate.build_cache import BuildCache


class PersistentBuildCache(BuildCache):
    """A :class:`BuildCache` whose second-level storage is a
    :class:`ProfileStore` directory shared across processes."""

    def __init__(self, provider: Provider, store):
        super().__init__(provider)
        self.store: ProfileStore = open_store(store)
        self.store.load_events(provider)
        self._known = set(provider.cache_snapshot())

    # ---- BuildCache hook points ----

    def _build_fallback(self, key: Tuple) -> Optional[EngineBuild]:
        return self.store.load_build(self.provider, key)

    def _build_created(self, key: Tuple, build: EngineBuild) -> None:
        self.store.save_build(self.provider, key, build)

    # ---- event persistence ----

    def flush(self) -> int:
        """Persist events profiled since construction (or the last
        flush) as one shard. Returns the number written."""
        snap = self.provider.cache_snapshot()
        delta = {e: t for e, t in snap.items() if e not in self._known}
        n = self.store.save_events(self.provider, delta) if delta else 0
        self._known = set(snap)
        return n

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["store"] = self.store.snapshot()
        return out
