"""Hierarchical modeling (paper §4.3, Algorithm 1).

Builds the full-cluster timeline bottom-up:

  1. MP level   — each layer becomes a ComposedEvent (sharded compute +
                  TP all-reduce (+ EP all-to-all)); times attached from the
                  (deduplicated) event profile.
  2. PP level   — layers → stages (or vpp virtual chunks); the pipeline
                  schedule's task lists are placed by the event-flow
                  engine's dependency-driven ready-queue: a task starts at
                  max(device free, input arrival) — exactly the paper's
                  ``first_available`` rule.
  3. DP level   — the (stage x microbatch) timeline is replicated DP
                  times; a gradient all-reduce (or ZeRO-1 reduce-scatter +
                  all-gather) synchronizes replicas at the end, followed
                  by the optimizer step.

The same constructor serves the replay oracle (``jitter_sigma > 0``):
per-instance event times are drawn around the profiled means and
per-device straggler/clock effects are added, which reproduces the
paper's observed error sources without owning the 16-GPU cluster.

The heavy lifting lives in :mod:`repro_torch.core.engine`; ``construct_timeline``
is a thin compatibility wrapper that builds an :class:`EventFlowEngine`
per call. Hold an engine directly (``DistSim`` does) to amortize the
per-strategy precomputation across predict + multi-seed replay runs.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.costmodel import ClusterSpec
from repro_torch.core.engine import EventFlowEngine
from repro_torch.core.events import (ComposedEvent, Stage, Strategy,
                               flatten_layers, layer_composed_events,
                               partition_stages)
from repro_torch.core.profiler import Provider
from repro_torch.core.scenario import TRAIN, Scenario
from repro_torch.core.timeline import Timeline


def build_positions(cfg: ArchConfig, strat: Strategy, microbatch: int,
                    seq: int, cluster: ClusterSpec,
                    scenario: Scenario = TRAIN) -> List[Stage]:
    """Stages for pp*vpp pipeline positions (vpp virtual chunks/device).

    Serving scenarios are forward-only (``bwd`` stays an empty bundle),
    use the *balanced* partition (an empty pipeline stage is merely
    wasteful in training but would stall every autoregressive step in
    decode), and — for decode — mark the last stage with the sampled-
    token feedback payload it sends back to stage 0 between steps.
    """
    if scenario.is_train:
        layers = flatten_layers(cfg, microbatch, seq)
        stages = partition_stages(layers, strat.pp * strat.vpp)
    else:
        if strat.vpp != 1:
            raise ValueError(
                f"scenario {scenario.label()!r} supports vpp=1 only "
                f"(got vpp={strat.vpp})")
        layers = flatten_layers(cfg, microbatch, seq, scenario=scenario)
        stages = partition_stages(layers, strat.pp, balanced=True)
    for st in stages:
        fwd, bwd = [], []
        for l in st.layers:
            fwd.extend(layer_composed_events(
                l, strat.mp, cluster.devices_per_island, "fwd").events)
            if scenario.is_train:
                bwd.extend(layer_composed_events(
                    l, strat.mp, cluster.devices_per_island, "bwd").events)
        st.fwd = ComposedEvent(f"pos{st.index}:fwd", fwd)
        st.bwd = ComposedEvent(f"pos{st.index}:bwd", bwd)
    if scenario.kind == "decode" and stages:
        # sampled token ids (int32 per slot) fed back to stage 0
        stages[-1].feedback_bytes = 4.0 * microbatch
    return stages


def construct_timeline(cfg: ArchConfig, strat: Strategy, global_batch: int,
                       seq: int, provider: Provider,
                       jitter_sigma: float = 0.0,
                       straggler_sigma: float = 0.0,
                       clock_sigma: float = 0.0,
                       seed: Optional[int] = None,
                       positions: Optional[List[Stage]] = None) -> Timeline:
    """One-shot timeline construction (API-compatible with the seed)."""
    if positions is None:
        microbatch = max(1, global_batch // (strat.dp * strat.microbatches))
        positions = build_positions(cfg, strat, microbatch, seq,
                                    provider.cluster)
    engine = EventFlowEngine(positions, strat, provider)
    return engine.run(jitter_sigma=jitter_sigma,
                      straggler_sigma=straggler_sigma,
                      clock_sigma=clock_sigma, seed=seed)
