"""Candidate pruning for strategy search.

Two sound filters applied before full timeline construction (Proteus /
DistIR-style: make the simulator cheap enough to sweep big grids):

1. **Memory feasibility** — the rough per-device HBM model (params /
   (mp*pp) with weights + grads + fp32 Adam state, plus live
   activations of one microbatch). Infeasible candidates are reported
   but never simulated.

2. **Work lower bound** — the busiest pipeline device must serially
   execute every microbatch's fwd+bwd composed events; no schedule,
   overlap, or comm pattern can beat that. If the bound already exceeds
   the best fully-simulated batch time, the candidate is dominated and
   timeline construction is skipped. The bound reuses the shared event
   profile, so pruning costs at most a few cache lookups.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ArchConfig
from repro_torch.core.events import Stage, Strategy
from repro_torch.core.modelgraph import kv_cache_bytes
from repro_torch.core.profiler import Provider
from repro_torch.core.scenario import TRAIN, Scenario

#: fraction of HBM usable for model state + activations
HBM_BUDGET = 0.92


def estimate_memory(cfg: ArchConfig, strat: Strategy, microbatch: int,
                    seq: int, scenario: Scenario = TRAIN) -> float:
    """Per-device bytes, scenario-aware.

    Train: params/mp/pp x (w + grad + 2 adam fp32) + live activations
    of one microbatch. Serving: bf16 weights only (no grads/optimizer)
    + live activations; decode additionally holds its share of the KV
    cache / SSM state (``microbatch`` = concurrent slots per replica,
    sharded over mp*pp like the layers that own it).
    """
    n = cfg.n_params()
    if scenario.is_train:
        state_bytes = n / (strat.mp * strat.pp) * (2 + 2 + 8 / (
            strat.dp if strat.zero1 else 1))
    else:
        state_bytes = n / (strat.mp * strat.pp) * 2        # bf16 weights
        if scenario.kind == "decode":
            state_bytes += kv_cache_bytes(
                cfg, microbatch, scenario.kv_len(seq)) / (strat.mp
                                                          * strat.pp)
    eff_seq = 1 if scenario.kind == "decode" else seq
    act = 2.0 * microbatch * eff_seq * cfg.d_model * 4   # rough live acts
    return state_bytes + act


def memory_feasible(cfg: ArchConfig, strat: Strategy, microbatch: int,
                    seq: int, hbm_bytes: float,
                    scenario: Scenario = TRAIN) -> bool:
    return estimate_memory(cfg, strat, microbatch, seq, scenario) \
        < hbm_bytes * HBM_BUDGET


def hbm_headroom(cfg: ArchConfig, strat: Strategy, microbatch: int,
                 seq: int, hbm_bytes: float,
                 scenario: Scenario = TRAIN) -> float:
    """Free HBM after model state + activations — one of the Pareto
    objectives (more headroom = larger future batches / longer seqs;
    for decode, more concurrent slots / longer contexts)."""
    return hbm_bytes * HBM_BUDGET - estimate_memory(cfg, strat,
                                                    microbatch, seq,
                                                    scenario)


def work_lower_bound(positions: List[Stage], strat: Strategy,
                     provider: Provider) -> float:
    """Sound batch-time lower bound from per-device serial work."""
    pp = strat.pp
    per_dev = [0.0] * pp
    for st in positions:
        per_dev[st.index % pp] += (
            sum(provider.time(e) for e in st.fwd.events)
            + sum(provider.time(e) for e in st.bwd.events))
    return strat.microbatches * max(per_dev, default=0.0)
