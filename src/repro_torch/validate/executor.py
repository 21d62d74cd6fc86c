"""Parallel sweep executor (tentpole of the sweep-scale subsystem).

The accuracy sweep is embarrassingly parallel per cell: cells only
interact through the shared profiling provider (the paper's
unique-event dedup) and the shared build cache. ``run_parallel`` fans
cells out over worker processes, each with its OWN provider shard
(seeded with the parent's already-profiled events) and its own
:class:`~repro_torch.validate.build_cache.BuildCache`, then merges the
shards back deterministically:

* **results** are reassembled in cell order, so the merged
  ``SweepResult`` — and its ``report.dump()`` JSON — is bit-identical
  to the serial sweep's (every per-cell number is a deterministic
  function of the cell + provider, not of scheduling);
* **event caches** merge by set-union with incumbent-wins semantics
  (values are identical across shards for a deterministic provider),
  so ``ProviderStats.evaluations`` afterwards equals the serial
  sweep's unique-event count: an event profiled by two shards still
  counts ONCE, exactly as the paper's Table 3 accounting requires;
* **hits** absorb the remaining shard lookups, so ``lookups`` stays
  the true number of provider queries performed.

Workers are started by fork where that is safe (cheap, no re-import)
and by spawn otherwise; the payloads (cells, provider, thresholds) are
all plain picklable dataclasses, so spawn-only platforms work too.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.profiler import Provider
from repro_torch.validate.build_cache import BuildCache, BuildCacheStats
from repro_torch.validate.sweep import (CellResult, Thresholds, ValidationCell,
                                        run_cell)


def _mp_context():
    """fork is the cheap path (no re-import in workers), but a forked
    child of a process that has initialized CUDA cannot use the card:
    spawn then. The sweep itself is numpy-only either way."""
    methods = multiprocessing.get_all_start_methods()
    if "fork" in methods and not torch.cuda.is_initialized():
        return multiprocessing.get_context("fork")
    return multiprocessing.get_context("spawn")


def _chunk(n: int, jobs: int) -> List[range]:
    """Contiguous near-even index chunks. Contiguity matters: the full
    matrix lists each (model, strategy) pair's four schedules
    consecutively, so keeping neighbors together maximizes each
    worker's build-cache hit rate."""
    base, extra = divmod(n, jobs)
    out, start = [], 0
    for w in range(jobs):
        size = base + (1 if w < extra else 0)
        out.append(range(start, start + size))
        start += size
    return [r for r in out if len(r)]


def _run_shard(payload) -> Tuple[List[Tuple[int, CellResult]], dict, int,
                                 BuildCacheStats]:
    """One worker: run a slice of cells against a private provider
    shard; report results, the shard's newly-profiled events, its
    lookup count and its build-cache accounting.

    With a ``store_path`` the shard provider arrives BARE (no pickled
    parent event cache): the worker opens the shared disk store, loads
    the persisted events (the parent flushed its own before spawning)
    and serves/persists engine builds through it — closing the old
    warm-cache gap where a passed ``BuildCache`` was neither consulted
    nor warmed under ``jobs > 1``."""
    (provider, indexed_cells, seeds, thresholds, jitter_sigma, batched,
     use_cache, store_path) = payload
    provider.stats.reset()
    store = None
    if store_path is not None:
        from repro_torch.store import PersistentBuildCache, open_store
        store = open_store(store_path)
        if use_cache:
            cache = PersistentBuildCache(provider, store)  # loads events
        else:
            cache = None
            store.load_events(provider)
    else:
        cache = BuildCache(provider) if use_cache else None
    known = set(provider.cache_snapshot())
    results = [(idx, run_cell(cell, provider, seeds, thresholds,
                              jitter_sigma, batched=batched, cache=cache))
               for idx, cell in indexed_cells]
    delta = {e: t for e, t in provider.cache_snapshot().items()
             if e not in known}
    if store is not None:
        if cache is not None:
            cache.flush()
        elif delta:
            store.save_events(provider, delta)
    cache_stats = cache.stats if cache is not None else BuildCacheStats()
    return results, delta, provider.stats.lookups, cache_stats


def run_parallel(cells: Sequence[ValidationCell], provider: Provider,
                 seeds: Sequence[int] = (0, 1, 2),
                 thresholds: Optional[Thresholds] = None,
                 jitter_sigma: float = 0.025, jobs: int = 2,
                 batched: bool = True, use_cache: bool = True,
                 cache_stats: Optional[BuildCacheStats] = None,
                 store=None) -> List[CellResult]:
    """Evaluate ``cells`` across ``jobs`` worker processes.

    Mutates ``provider`` exactly as the serial sweep would: its event
    cache gains the union of all shards' profiled events and its stats
    advance by the serial-equivalent (evaluations += newly unique,
    hits += remaining lookups). Pass ``cache_stats`` to additionally
    accumulate the shards' build-cache accounting.

    ``store`` (a :class:`repro_torch.store.ProfileStore` or path) switches
    the shard hand-off to disk: the parent flushes its profiled events
    once, ships BARE providers (no pickled event cache per shard), and
    each worker opens the store for warm events + persisted engine
    builds, flushing its own additions back. Results and accounting
    stay identical; the store — not a per-run in-memory cache — is
    what survives for the next process.
    """
    thresholds = thresholds or Thresholds()
    cells = list(cells)
    jobs = max(1, min(int(jobs), len(cells) or 1))
    if store is not None:
        from repro_torch.store import PersistentBuildCache, open_store
        store = open_store(store)
    if jobs == 1:
        if store is not None and use_cache:
            cache = PersistentBuildCache(provider, store)
        elif store is not None:
            cache = None
            store.load_events(provider)
        else:
            cache = BuildCache(provider) if use_cache else None
        known = set(provider.cache_snapshot()) if store is not None \
            else None
        out = [run_cell(c, provider, seeds, thresholds, jitter_sigma,
                        batched=batched, cache=cache)
               for c in cells]
        if store is not None:
            if cache is not None:
                cache.flush()
            else:
                delta = {e: t
                         for e, t in provider.cache_snapshot().items()
                         if e not in known}
                if delta:
                    store.save_events(provider, delta)
        if cache is not None and cache_stats is not None:
            cache_stats.merge(cache.stats)
        return out

    if store is not None:
        # disk is the shard hand-off: parent's events go through the
        # store once, workers start from a BARE provider
        store.load_events(provider)
        store.save_events(provider)
        ship = provider.bare()
        store_path = store.path
    else:
        ship = provider
        store_path = None
    payloads = []
    for idx_range in _chunk(len(cells), jobs):
        indexed = [(i, cells[i]) for i in idx_range]
        payloads.append((ship, indexed, tuple(seeds), thresholds,
                         jitter_sigma, batched, use_cache, store_path))

    with ProcessPoolExecutor(max_workers=len(payloads),
                             mp_context=_mp_context()) as pool:
        shards = list(pool.map(_run_shard, payloads))

    results: List[Optional[CellResult]] = [None] * len(cells)
    new_events = 0
    total_lookups = 0
    for shard_results, delta, lookups, shard_cache_stats in shards:
        for idx, res in shard_results:
            results[idx] = res
        new_events += provider.merge_cache(delta)
        total_lookups += lookups
        if cache_stats is not None:
            cache_stats.merge(shard_cache_stats)
    # serial-equivalent accounting: each unique event counts once no
    # matter how many shards profiled it; everything else was a reuse
    provider.stats.evaluations += new_events
    provider.stats.hits += total_lookups - new_events
    if store is not None:
        # absorb events persisted by workers (or concurrent writers)
        # that no shard delta carried — merge_cache leaves stats alone
        store.load_events(provider)
    assert all(r is not None for r in results)
    return results
