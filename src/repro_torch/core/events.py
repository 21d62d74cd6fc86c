"""DistSim events: deduplicated units of profiling (paper §3.2, §4.1).

An ``Event`` is an *identical* piece of work performed by possibly many
devices / many microbatches — the key to the paper's Observation 1
(profiling redundancy): it's profiled ONCE. Identity is structural:
(kind, op descriptor, sharded shapes, participant count, intra/inter
scope). Two replicas computing the same sharded layer hash to the same
event; so do all microbatches of a pipeline stage.

``Strategy`` captures the hybrid-parallelism configuration "xM xP xD"
from the paper plus our beyond-paper axes (ZeRO-1, EP).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.modelgraph import (GEMM, LayerSpec, build_decode_graph,
                                   build_graph)
from repro_torch.core.scenario import TRAIN, Scenario


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Hybrid distributed training strategy ("xM xP xD")."""
    mp: int = 1                   # tensor/model parallel degree
    pp: int = 1                   # pipeline parallel degree
    dp: int = 1                   # data parallel degree
    microbatches: int = 1         # per-replica microbatch count M
    schedule: str = "1f1b"        # gpipe | 1f1b (Dapple) | interleaved
    zero1: bool = False           # shard optimizer state over dp
    # gradient compression ratio on the DP sync (1.0 = off; 0.25 = int8
    # + scales, as a training stack would apply). A DistSim what-if knob.
    grad_compress: float = 1.0
    # interleaved: virtual stages per device (Megatron interleaved 1F1B)
    vpp: int = 1

    @property
    def devices(self) -> int:
        return self.mp * self.pp * self.dp

    def label(self) -> str:
        return f"{self.mp}M{self.pp}P{self.dp}D"

    def microbatch_size(self, global_batch: int) -> int:
        """Per-microbatch sample count with the ``max(1, ...)`` floor.
        The ONE definition of the microbatch-derivation formula —
        ``DistSim.microbatch`` and ``validate.BuildCache`` both call
        this, so the cache key and the simulator can't drift apart
        (the drift class ``profiling_report()`` once suffered from)."""
        return max(1, global_batch // (self.dp * self.microbatches))

    # ---- JSON round-trip (repro_torch.validate reports, goldens) ----
    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Strategy":
        from repro_torch.core.serde import dataclass_from_dict
        return dataclass_from_dict(cls, d)


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str                       # compute | collective | p2p | hbm
    # display-only: equality/hashing is the STRUCTURAL signature
    # (kind, op, sharded shapes, participants, scope) — the paper's
    # unique-event identity. Two stages' p2p sends of the same payload
    # are ONE profiling event even though their labels differ.
    name: str = dataclasses.field(compare=False)
    gemms: Tuple[GEMM, ...] = ()    # compute: sharded GEMM dims
    coll_op: str = ""               # collective: all_reduce | all_gather | ...
    nbytes: float = 0.0             # collective/p2p payload (full tensor)
    n_dev: int = 1                  # collective participant count
    scope: str = "intra"            # intra | inter (island)

    @property
    def flops(self) -> float:
        return sum(g.flops for g in self.gemms)


@dataclasses.dataclass
class ComposedEvent:
    """Paper §3.2: one strategy level's bundle of events.

    For MP modeling, a layer's forward = [compute event, TP all-reduce,
    (EP all-to-all)]. Times are attached later by the profiler.
    """
    name: str
    events: List[Event]

    def total(self, profile: Dict[Event, float]) -> float:
        return sum(profile[e] for e in self.events)


# --------------------------------------------------------------------------
# MP-level modeling (paper §4.3 "Model Parallelism Modeling")
# --------------------------------------------------------------------------

def _shard_gemms(spec: LayerSpec, mp: int) -> Tuple[GEMM, ...]:
    return tuple(g.shard(mp, ax) for g, ax in zip(spec.gemms,
                                                  spec.shard_axes))


def _scope(ranks_span: int, devices_per_island: int) -> str:
    return "intra" if ranks_span <= devices_per_island else "inter"


def layer_composed_events(spec: LayerSpec, mp: int, devices_per_island: int,
                          phase: str) -> ComposedEvent:
    """ComposedEvent for one layer's fwd or bwd under MP=mp."""
    assert phase in ("fwd", "bwd")
    mult = 1 if phase == "fwd" else 2
    gemms = _shard_gemms(spec, mp) if spec.mp_shardable else spec.gemms
    if mult == 2:
        gemms = gemms + gemms           # dgrad + wgrad, same dims class
    events = [Event(kind="compute",
                    name=f"{spec.name}:{phase}:mp{mp}",
                    gemms=gemms)]
    if mp > 1 and spec.tp_allreduce_bytes:
        events.append(Event(
            kind="collective", name=f"{spec.name}:{phase}:tp_ar:mp{mp}",
            coll_op="all_reduce", nbytes=spec.tp_allreduce_bytes,
            n_dev=mp, scope=_scope(mp, devices_per_island)))
    if mp > 1 and spec.ep_alltoall_bytes:
        events.append(Event(
            kind="collective", name=f"{spec.name}:{phase}:ep_a2a:mp{mp}",
            coll_op="all_to_all", nbytes=spec.ep_alltoall_bytes / mp,
            n_dev=mp, scope=_scope(mp, devices_per_island)))
    if spec.kv_read_bytes:
        # decode: KV-cache / SSM-state read from HBM (sharded with the
        # KV heads under TP)
        shard = mp if spec.mp_shardable else 1
        events.append(Event(
            kind="hbm", name=f"{spec.name}:{phase}:kv_read:mp{mp}",
            nbytes=spec.kv_read_bytes / shard))
    return ComposedEvent(f"{spec.name}:{phase}", events)


# --------------------------------------------------------------------------
# stage partitioning (PP level input)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Stage:
    index: int
    layers: List[LayerSpec]         # flattened (one entry per actual layer)
    fwd: Optional[ComposedEvent] = None
    bwd: Optional[ComposedEvent] = None
    # decode: payload the LAST stage feeds back to stage 0 between
    # autoregressive steps (sampled token ids). 0.0 for train/prefill.
    # A class-level default so stages unpickled from pre-scenario
    # stores read 0.0 via the class attribute.
    feedback_bytes: float = 0.0

    @property
    def param_bytes(self) -> float:
        return sum(l.param_bytes for l in self.layers)

    @property
    def boundary_act_bytes(self) -> float:
        return self.layers[-1].act_bytes if self.layers else 0.0


def flatten_layers(cfg: ArchConfig, microbatch: int, seq: int,
                   scenario: Scenario = TRAIN,
                   layers: Optional[List[LayerSpec]] = None
                   ) -> List[LayerSpec]:
    """Flatten the model into one entry per actual layer.

    ``scenario`` selects the layer graph (train/prefill share the full-
    sequence forward graph; decode builds the seq=1 graph with KV-read
    terms). An explicit ``layers`` list overrides the generated graph —
    the hook for heterogeneous per-layer configurations (non-uniform
    widths, per-layer seq) that no ``ArchConfig`` template expresses.
    """
    if layers is None:
        if scenario.kind == "decode":
            layers = build_decode_graph(cfg, microbatch,
                                        scenario.kv_len(seq))
        else:
            layers = build_graph(cfg, microbatch, seq)
    out: List[LayerSpec] = []
    for spec in layers:
        out.extend([spec] * spec.count)
    return out


def partition_stages(layers: List[LayerSpec], pp: int,
                     balanced: bool = False) -> List[Stage]:
    """Balance stages by forward FLOPs (greedy prefix split).

    With ``balanced=True`` every stage is guaranteed non-empty whenever
    ``len(layers) >= pp`` (the greedy split is forced once exactly one
    layer per remaining stage is left). The default keeps the historic
    behaviour — tiny models may pad trailing empty stages — because
    existing training goldens bake that in.
    """
    total = sum(l.fwd_flops for l in layers) or 1.0
    target = total / pp
    stages: List[Stage] = []
    cur: List[LayerSpec] = []
    acc = 0.0
    idx = 0
    for i, l in enumerate(layers):
        cur.append(l)
        acc += l.fwd_flops
        remaining_layers = len(layers) - i - 1
        remaining_stages = pp - idx - 1
        force = balanced and remaining_layers == remaining_stages
        if ((acc >= target or force) and remaining_stages > 0
                and remaining_layers >= remaining_stages):
            stages.append(Stage(idx, cur))
            idx, cur, acc = idx + 1, [], 0.0
    stages.append(Stage(idx, cur))
    while len(stages) < pp:                       # degenerate tiny models
        stages.append(Stage(len(stages), []))
    return stages


def build_stage_events(cfg: ArchConfig, strat: Strategy, microbatch: int,
                       seq: int, devices_per_island: int) -> List[Stage]:
    layers = flatten_layers(cfg, microbatch, seq)
    stages = partition_stages(layers, strat.pp)
    for st in stages:
        fwd_events: List[Event] = []
        bwd_events: List[Event] = []
        for l in st.layers:
            fwd_events.extend(layer_composed_events(
                l, strat.mp, devices_per_island, "fwd").events)
            bwd_events.extend(layer_composed_events(
                l, strat.mp, devices_per_island, "bwd").events)
        st.fwd = ComposedEvent(f"stage{st.index}:fwd", fwd_events)
        st.bwd = ComposedEvent(f"stage{st.index}:bwd", bwd_events)
    return stages


# --------------------------------------------------------------------------
# event universe + dedup accounting (Table 3 metric)
# --------------------------------------------------------------------------

def stage_event_set(stages: List[Stage]) -> "set[Event]":
    """Unique compute/comm events across a stage list — the profiling
    working set a candidate strategy adds to a shared cache."""
    out: set = set()
    for st in stages:
        if st.fwd is not None:
            out.update(st.fwd.events)
        if st.bwd is not None:
            out.update(st.bwd.events)
    return out


def stage_signature(stages: List[Stage]) -> Tuple:
    """Structural identity of a positions list — exactly what an
    :class:`repro_torch.core.engine.EventFlowEngine` reads from it: the
    per-position fwd/bwd event tuples (structural ``Event`` identity,
    names excluded) plus the boundary/param byte counts. Two lists with
    equal signatures build bit-identical engines, so ``DistSim.engine``
    keys its cache on this rather than on list object identity (which
    both missed equal-content rebuilds and silently reused engines for
    mutated lists)."""
    return tuple(
        (tuple(st.fwd.events) if st.fwd is not None else (),
         tuple(st.bwd.events) if st.bwd is not None else (),
         st.boundary_act_bytes, st.param_bytes,
         getattr(st, "feedback_bytes", 0.0))
        for st in stages)


def unique_events(stages: List[Stage], strat: Strategy,
                  devices_per_island: int) -> Dict[Event, int]:
    """All unique events with their total instance counts across the
    cluster & microbatches — the dedup ratio drives Table 3."""
    counts: Dict[Event, int] = {}

    def add(e: Event, n: int):
        counts[e] = counts.get(e, 0) + n

    m = strat.microbatches
    for st in stages:
        for e in st.fwd.events + st.bwd.events:
            add(e, m * strat.mp * strat.dp)
        if st.index < len(stages) - 1:
            span = strat.mp                      # stage boundary rank stride
            add(Event(kind="p2p", name=f"p2p:s{st.index}",
                      nbytes=st.boundary_act_bytes,
                      scope=_scope(span + 1, devices_per_island)),
                2 * m * strat.mp * strat.dp)     # fwd act + bwd grad
        if strat.dp > 1:
            add(Event(kind="collective", name=f"dp_ar:s{st.index}",
                      coll_op="all_reduce",
                      nbytes=st.param_bytes / max(1, strat.mp),
                      n_dev=strat.dp,
                      scope=_scope(strat.dp * strat.pp * strat.mp,
                                   devices_per_island)),
                strat.mp * strat.dp)
    return counts
