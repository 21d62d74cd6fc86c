"""Event profiling (paper §4.2).

Each unique event is profiled ONCE:

* ``AnalyticalProvider`` — operator-level roofline under the systolic
  ``mxu_efficiency`` curve (the "Habitat-style predictor" pathway the
  paper offers for users without profiling hardware). Same class name
  and arithmetic as the reference package, so a profile store written
  by either serves the other for the copied cluster presets.

* ``HopperAnalyticalProvider`` — the same roofline under the Hopper
  ``tensor_core_efficiency`` curve: the provider of the H100 targets.
  A class of its own because the store namespace keys on the class
  name, and its times are different numbers.

* ``TorchMeasuredProvider`` — actually executes each compute event's
  GEMMs with PyTorch on a device and times them (the analogue of the
  paper's 2-node profiling). Communication events still use the ring
  model — one card has no link to measure, the same situation the paper
  solves by extrapolating ≤8-way profiles (§4.2: error contribution
  <2%).

Times are cached per event — repeated strategies re-use profiles, as the
paper notes ("events' time can be stored and reused").
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable

import torch

from repro_torch.core.costmodel import (H100_CLUSTER, ClusterSpec,
                                        collective_time, compute_time,
                                        hbm_time, p2p_time, ring_hops,
                                        ring_volume_factor)
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.events import Event
from repro_torch.core.hw import tensor_core_efficiency


@dataclasses.dataclass
class ProviderStats:
    """Profiling-cost accounting for the search engine.

    ``evaluations`` counts real cost-model evaluations (cache misses) —
    the quantity the paper's unique-event dedup minimizes; ``hits``
    counts reuses of an already-profiled event.
    """
    evaluations: int = 0
    hits: int = 0

    @property
    def lookups(self) -> int:
        return self.evaluations + self.hits

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def reset(self) -> None:
        self.evaluations = 0
        self.hits = 0


class Provider:
    def __init__(self, cluster: ClusterSpec = H100_CLUSTER):
        self.cluster = cluster
        self._cache: Dict[Event, float] = {}
        self.stats = ProviderStats()
        #: bumped on every cache clear; consumers that bake cached times
        #: into derived structures (EventFlowEngine, validate.BuildCache)
        #: stamp themselves with this and rebuild on mismatch.
        self.cache_version = 0

    def time(self, e: Event) -> float:
        if e not in self._cache:
            self._cache[e] = self._time(e)
            self.stats.evaluations += 1
        else:
            self.stats.hits += 1
        return self._cache[e]

    def cached_time(self, e: Event) -> float:
        """Profiled time of an already-cached event, without touching
        the hit/miss accounting (bookkeeping reads, e.g. the search
        engine's per-candidate profiling-cost sum)."""
        return self._cache[e]

    def clear_cache(self) -> None:
        """Drop profiled event times (stats are kept; reset separately).
        Bumps :attr:`cache_version` so engines holding baked-in means
        from the old cache are invalidated, not silently reused, and
        clears any subclass-derived caches (:meth:`_clear_derived`) so
        re-profiling can't serve measurements from before the clear."""
        self._cache.clear()
        self._clear_derived()
        self.cache_version += 1

    def _clear_derived(self) -> None:
        """Hook for subclasses holding caches derived from profiling
        (e.g. ``TorchMeasuredProvider._group_cache``): called by
        :meth:`clear_cache` so a clear drops EVERYTHING, not just the
        event-time dict."""

    @property
    def cache_size(self) -> int:
        """Number of unique events currently profiled — the public
        accessor for accounting surfaces (``ProfileCache``, stores)
        that previously reached into ``_cache``."""
        return len(self._cache)

    def namespace_extra(self) -> Dict:
        """Extra identity a profile store folds into this provider's
        namespace beside the class name and the cluster. Empty for
        deterministic providers (keeping their namespaces equal to the
        reference package's); a measured provider names what its times
        were taken on."""
        return {}

    def bare(self) -> "Provider":
        """Copy of this provider with EMPTY event/derived caches and
        fresh stats (same cluster, config and ``cache_version``) — what
        the parallel executor ships to worker processes when a disk
        :class:`repro_torch.store.ProfileStore` carries the warm events
        instead of the pickled parent cache."""
        import copy
        p = copy.copy(self)
        p._cache = {}
        p.stats = ProviderStats()
        return p

    # ---- parallel-sweep shard support (repro_torch.validate.executor) ----
    def cache_snapshot(self) -> Dict[Event, float]:
        """Copy of the profiled-event cache (picklable: Events are
        frozen dataclasses) — what a worker shard sends back."""
        return dict(self._cache)

    def merge_cache(self, entries: Dict[Event, float]) -> int:
        """Merge a shard's profiled events; existing entries win (values
        are identical for a deterministic provider — keeping the
        incumbent makes the merge order-independent). Returns how many
        events were new. Stats are NOT touched: the executor
        reconstructs serial-equivalent accounting from shard lookups."""
        fresh = 0
        for e, t in entries.items():
            if e not in self._cache:
                self._cache[e] = t
                fresh += 1
        return fresh

    def _time(self, e: Event) -> float:
        if e.kind == "compute":
            return self._compute_time(e)
        if e.kind == "collective":
            n = e.n_dev
            if n > 8:
                # paper §4.2: profile 8-way, extrapolate by ring volume.
                # We additionally remove/re-add the per-hop latency term
                # (known from the cluster spec) so the extrapolation is
                # exact — the paper bounds the residual effect at <2%.
                lat = (self.cluster.intra_latency if e.scope == "intra"
                       else self.cluster.inter_latency)
                t8 = (collective_time(e.coll_op, e.nbytes, 8, self.cluster,
                                      e.scope)
                      - ring_hops(e.coll_op, 8) * lat)
                v8 = ring_volume_factor(e.coll_op, 8)
                vn = ring_volume_factor(e.coll_op, n)
                return t8 * vn / v8 + ring_hops(e.coll_op, n) * lat
            return collective_time(e.coll_op, e.nbytes, n, self.cluster,
                                   e.scope)
        if e.kind == "p2p":
            # dPRO's min(SEND, RECV) rule: our model times the transmission
            # itself, which is that minimum by construction.
            return p2p_time(e.nbytes, self.cluster, e.scope)
        if e.kind == "hbm":
            # decode KV-cache / SSM-state read: pure HBM-bandwidth-bound
            return hbm_time(e.nbytes, self.cluster)
        raise ValueError(e.kind)

    def _compute_time(self, e: Event) -> float:
        raise NotImplementedError


class AnalyticalProvider(Provider):
    def _compute_time(self, e: Event) -> float:
        return compute_time(e.gemms, self.cluster.chip)


class HopperAnalyticalProvider(Provider):
    """Analytical provider of the H100 targets: the operator roofline
    under :func:`repro_torch.core.hw.tensor_core_efficiency`."""

    def _compute_time(self, e: Event) -> float:
        return compute_time(e.gemms, self.cluster.chip,
                            tensor_core_efficiency)


def provider_for(cluster: ClusterSpec) -> Provider:
    """The analytical provider that fits ``cluster``'s chip: the Hopper
    curve for an H100 target, the systolic curve for every preset
    copied from the reference (whose store namespaces it shares)."""
    if cluster.chip.name.startswith("h100"):
        return HopperAnalyticalProvider(cluster)
    return AnalyticalProvider(cluster)


class TorchMeasuredProvider(Provider):
    """Times real PyTorch op groups on ``device`` (the card by default).

    An event's GEMMs are executed back to back as one group — the
    operator-level granularity the paper profiles. A per-GEMM silu
    epilogue approximates the activation/softmax traffic between the
    GEMMs. The GEMMs are plain ``torch.matmul`` calls.

    ``dtype`` is the operands' type and is explicit: bf16 by default
    (what the H100 target's peak is stated in). For ``torch.float32``
    the product runs in full fp32 unless ``tf32=True``; the flag is set
    for the duration of a timing and restored, never left to the
    process default. On a CUDA device a group is timed with
    ``torch.cuda.Event`` pairs after one warm-up run, min over
    ``reps``; with ``device="cpu"`` (asked for by the caller, never
    chosen here) with ``time.perf_counter``.
    """

    def __init__(self, cluster: ClusterSpec = H100_CLUSTER, reps: int = 3,
                 device=DEFAULT_DEVICE,
                 dtype: torch.dtype = torch.bfloat16, tf32: bool = False):
        super().__init__(cluster)
        self.reps = reps
        self.device = resolve_device(device)
        self.dtype = dtype
        self.tf32 = tf32
        self._group_cache: Dict[tuple, float] = {}

    def namespace_extra(self) -> Dict:
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {"device": kind, "dtype": str(self.dtype),
                "tf32": bool(self.tf32)}

    def _clear_derived(self) -> None:
        # without this, a clear_cache() followed by re-profiling would
        # silently reuse timings measured before the clear
        self._group_cache.clear()

    def bare(self) -> "TorchMeasuredProvider":
        p = super().bare()
        p._group_cache = {}
        return p

    def _inputs(self, dims: tuple):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)          # operands are random but reproducible
        return [(torch.randn((m, k), generator=gen, device=self.device,
                             dtype=torch.float32).to(self.dtype),
                 torch.randn((k, n), generator=gen, device=self.device,
                             dtype=torch.float32).to(self.dtype))
                for m, n, k in dims]

    @staticmethod
    def _run(inputs) -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32,
                          device=inputs[0][0].device)
        for a, b in inputs:
            y = torch.nn.functional.silu(torch.matmul(a, b))  # epilogue
            acc = acc + y.sum(dtype=torch.float32)
        return acc

    def _time_group(self, dims: tuple) -> float:
        if dims in self._group_cache:
            return self._group_cache[dims]
        on_card = self.device.type == "cuda"
        was_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            with torch.no_grad():
                inputs = self._inputs(dims)
                self._run(inputs)                         # warm-up
                best = float("inf")
                for _ in range(self.reps):
                    if on_card:
                        t0 = torch.cuda.Event(enable_timing=True)
                        t1 = torch.cuda.Event(enable_timing=True)
                        t0.record()
                        self._run(inputs)
                        t1.record()
                        t1.synchronize()
                        best = min(best, t0.elapsed_time(t1) * 1e-3)
                    else:
                        c0 = time.perf_counter()
                        self._run(inputs)
                        best = min(best, time.perf_counter() - c0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was_tf32
        self._group_cache[dims] = best
        return best

    def _compute_time(self, e: Event) -> float:
        dims = tuple((g.m, g.n, g.k) for g in e.gemms)
        return self._time_group(dims) if dims else 0.0


def profile_events(events: Iterable[Event], provider: Provider
                   ) -> Dict[Event, float]:
    return {e: provider.time(e) for e in events}


def profiling_cost(counts: Dict[Event, int], profile: Dict[Event, float]
                   ) -> Dict[str, float]:
    """Table 3: DistSim profiles each unique event once vs direct running
    profiling every instance on every device."""
    unique_t = sum(profile[e] for e in counts)
    direct_t = sum(profile[e] * c for e, c in counts.items())
    return {
        "unique_events": len(counts),
        "total_instances": int(sum(counts.values())),
        "profile_time_s": unique_t,
        "direct_time_s": direct_t,
        "relative_scale": unique_t / direct_t if direct_t else 1.0,
    }
