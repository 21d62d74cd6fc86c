"""Use-case: automatic hybrid-parallel strategy search (paper §6).

DEPRECATED compatibility surface over :mod:`repro_torch.search` — the
subsystem that adds a shared profile cache, dominance pruning,
mega-batch vectorized scoring and multi-cluster Pareto search.
``grid_search`` keeps the seed signature and behavior (every candidate
fully simulated, one provider, full sorted ranking with OOM entries
included) but emits a :class:`DeprecationWarning`: new code should
drive :class:`repro_torch.search.SearchEngine` directly.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.costmodel import H100_CLUSTER
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.core.profiler import Provider, provider_for
from repro_torch.search.cache import ProfileCache
from repro_torch.search.engine import SearchEngine, SearchEntry
from repro_torch.search.prune import estimate_memory, memory_feasible

__all__ = ["SearchEntry", "grid_search", "memory_feasible",
           "estimate_memory"]


def grid_search(cfg: ArchConfig, n_devices: int, global_batch: int,
                seq: int, provider: Optional[Provider] = None,
                microbatches: Optional[Sequence[int]] = None,
                schedules: Sequence[str] = ("1f1b",),
                check_memory: bool = False,
                device=DEFAULT_DEVICE) -> List[SearchEntry]:
    """Deprecated: use ``repro_torch.search.SearchEngine(...).search(...)``
    (``device`` is the engine's: the card unless the caller passes
    ``"cpu"``)."""
    warnings.warn(
        "repro_torch.core.search.grid_search is deprecated; use "
        "repro_torch.search.SearchEngine(cfg, ...).search(...)",
        DeprecationWarning, stacklevel=2)
    provider = provider or provider_for(H100_CLUSTER)
    engine = SearchEngine(cfg, cache=ProfileCache.from_provider(provider),
                          prune=False, check_memory=check_memory,
                          device=device)
    result = engine.search(n_devices, global_batch, seq,
                           microbatches=microbatches, schedules=schedules)
    return result.entries
