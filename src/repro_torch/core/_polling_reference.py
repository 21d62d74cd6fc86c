"""Historical polling scheduler — benchmark baseline + differential oracle.

This is the seed implementation of ``construct_timeline`` (pre
``repro_torch.core.engine``), kept verbatim as the reference package
keeps it: the baseline the event-flow engine's speedup is measured
against, and the differential oracle its zero-noise predict path was
built to agree with. ``tests/test_torch_validate.py`` holds this copy
bit-identical to the reference's.

It rescans every (replica, device) queue until progress —
O((dp·pp)²·tasks) — and carries two replay-oracle modeling bugs the
engine fixes (per-activity clock offsets; non-synchronizing DP
all-reduce). Do NOT use it for new code; ``construct_timeline`` in
``repro_torch.core.hierarchy`` is the supported entry point.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.events import ComposedEvent, Event, Stage, Strategy
from repro_torch.core.profiler import Provider
from repro_torch.core.schedules import build_schedule
from repro_torch.core.timeline import Activity, Timeline


@dataclasses.dataclass
class _Jitter:
    rng: Optional[np.random.RandomState]
    sigma: float
    speed: np.ndarray            # (dp, pp) per-device multiplicative factor

    def draw(self, mean: float, r: int, d: int) -> float:
        if self.rng is None or mean == 0.0:
            return mean * self.speed[r, d]
        f = max(0.05, 1.0 + self.sigma * self.rng.randn())
        return mean * f * self.speed[r, d]


def construct_timeline_polling(cfg: ArchConfig, strat: Strategy,
                               global_batch: int, seq: int,
                               provider: Provider,
                               jitter_sigma: float = 0.0,
                               straggler_sigma: float = 0.0,
                               clock_sigma: float = 0.0,
                               seed: Optional[int] = None,
                               positions: Optional[List[Stage]] = None
                               ) -> Timeline:
    from repro_torch.core.hierarchy import build_positions

    cluster = provider.cluster
    m = strat.microbatches
    microbatch = max(1, global_batch // (strat.dp * m))
    stages = (positions if positions is not None
              else build_positions(cfg, strat, microbatch, seq, cluster))
    sched = build_schedule(strat.schedule, strat.pp, m, strat.vpp)
    pp, dp, vpp = strat.pp, strat.dp, strat.vpp
    n_pos = len(stages)

    rng = np.random.RandomState(seed) if seed is not None else None
    speed = np.ones((dp, pp))
    if rng is not None and straggler_sigma > 0:
        speed = 1.0 + straggler_sigma * np.abs(rng.randn(dp, pp))
    jit = _Jitter(rng, jitter_sigma, speed)

    def composed_dur(ce: ComposedEvent, r: int, d: int) -> float:
        return sum(jit.draw(provider.time(e), r, d) for e in ce.events)

    def p2p_event(pos: int, phase: str) -> Event:
        span = strat.mp + 1
        scope = ("intra" if span <= cluster.devices_per_island else "inter")
        return Event(kind="p2p", name=f"p2p:{phase}:pos{pos}",
                     nbytes=stages[pos].boundary_act_bytes, scope=scope)

    acts: List[Activity] = []       # per (r, d) canonical activities
    free: Dict[Tuple[int, int], float] = {(r, d): 0.0
                                          for r in range(dp)
                                          for d in range(pp)}
    ptr = {(r, d): 0 for r in range(dp) for d in range(pp)}
    f_end: Dict[Tuple[int, int, int], float] = {}   # (r, pos, micro)
    arr_f: Dict[Tuple[int, int, int], float] = {}   # forward act arrival
    arr_b: Dict[Tuple[int, int, int], float] = {}   # backward grad arrival

    total = dp * sum(len(s) for s in sched)
    done = 0
    while done < total:
        progress = False
        for r in range(dp):
            for d in range(pp):
                while ptr[(r, d)] < len(sched[d]):
                    t = sched[d][ptr[(r, d)]]
                    pos = t.chunk * pp + d
                    if t.phase == "F":
                        if pos == 0:
                            ready = 0.0
                        else:
                            key = (r, pos, t.micro)
                            if key not in arr_f:
                                break
                            ready = arr_f[key]
                        dur = composed_dur(stages[pos].fwd, r, d)
                    else:
                        fkey = (r, pos, t.micro)
                        if fkey not in f_end:
                            break
                        ready = f_end[fkey]
                        if pos < n_pos - 1:
                            bkey = (r, pos, t.micro)
                            if bkey not in arr_b:
                                break
                            ready = max(ready, arr_b[bkey])
                        dur = composed_dur(stages[pos].bwd, r, d)

                    start = max(free[(r, d)], ready)
                    end = start + dur
                    free[(r, d)] = end
                    acts.append(Activity(
                        device=r * pp + d,
                        name=f"{t.phase}:s{pos}:m{t.micro}",
                        kind=t.phase, start=start, end=end,
                        stage=pos, micro=t.micro))

                    if t.phase == "F":
                        f_end[(r, pos, t.micro)] = end
                        if pos < n_pos - 1:
                            pt = jit.draw(provider.time(p2p_event(pos, "f")),
                                          r, d)
                            arr_f[(r, pos + 1, t.micro)] = end + pt
                            acts.append(Activity(
                                device=r * pp + d,
                                name=f"P2P:f:s{pos}:m{t.micro}",
                                kind="P2P", start=end, end=end + pt,
                                stage=pos, micro=t.micro))
                    else:
                        if pos > 0:
                            pt = jit.draw(
                                provider.time(p2p_event(pos - 1, "b")), r, d)
                            arr_b[(r, pos - 1, t.micro)] = end + pt
                            acts.append(Activity(
                                device=r * pp + d,
                                name=f"P2P:b:s{pos}:m{t.micro}",
                                kind="P2P", start=end, end=end + pt,
                                stage=pos, micro=t.micro))
                    ptr[(r, d)] += 1
                    done += 1
                    progress = True
        if not progress:
            raise RuntimeError(
                f"pipeline schedule deadlock: {strat.label()} "
                f"{strat.schedule} done={done}/{total}")

    # ---------------- DP level: gradient sync + optimizer ----------------
    chip = cluster.chip
    for d in range(pp):
        pos_list = [c * pp + d for c in range(vpp) if c * pp + d < n_pos]
        pbytes = sum(stages[p].param_bytes for p in pos_list) / max(1, strat.mp)
        pbytes *= strat.grad_compress       # int8 compression what-if
        # asynchronous pipelining (PipeDream): no global weight sync —
        # each device steps its optimizer immediately (paper §7)
        sync = dp > 1 and strat.schedule != "pipedream"
        sync_start = max(free[(r, d)] for r in range(dp))
        for r in range(dp):
            t0 = max(free[(r, d)], sync_start if sync else free[(r, d)])
            if sync:
                span = dp * pp * strat.mp
                scope = ("intra" if span <= cluster.devices_per_island
                         else "inter")
                if strat.zero1:
                    ar = (provider.time(Event(
                        kind="collective", name=f"dp_rs:d{d}",
                        coll_op="reduce_scatter", nbytes=pbytes,
                        n_dev=dp, scope=scope))
                        + provider.time(Event(
                            kind="collective", name=f"dp_ag:d{d}",
                            coll_op="all_gather", nbytes=pbytes,
                            n_dev=dp, scope=scope)))
                else:
                    ar = provider.time(Event(
                        kind="collective", name=f"dp_ar:d{d}",
                        coll_op="all_reduce", nbytes=pbytes,
                        n_dev=dp, scope=scope))
                # SEED BUG (fixed in repro_torch.core.engine): each replica
                # exits the blocking collective at its own jittered time.
                ar = jit.draw(ar, r, d)
                acts.append(Activity(device=r * pp + d, name=f"AR:d{d}",
                                     kind="AR", start=t0, end=t0 + ar,
                                     stage=d))
                t0 += ar
            # AdamW: streams fp32 master params + m + v (~6 passes of 2x)
            opt_bytes = pbytes * (1 if not strat.zero1 else 1.0 / dp)
            opt = jit.draw(6.0 * opt_bytes * 2 / chip.hbm_bw, r, d)
            acts.append(Activity(device=r * pp + d, name=f"OPT:d{d}",
                                 kind="OPT", start=t0, end=t0 + opt,
                                 stage=d))
            free[(r, d)] = t0 + opt

    # ---------------- replicate over MP ranks ----------------
    out: List[Activity] = []
    mp = strat.mp
    for a in acts:
        base = a.device * mp
        for j in range(mp):
            off = 0.0
            # SEED BUG (fixed in repro_torch.core.engine): clock skew drawn
            # per ACTIVITY instead of once per device per run.
            if rng is not None and clock_sigma > 0:
                off = clock_sigma * rng.randn()
            out.append(dataclasses.replace(
                a, device=base + j, start=a.start + off, end=a.end + off))
    return Timeline(out, n_devices=dp * pp * mp)
