"""Pipeline schedules (paper §2.1.3, §4.3): GPipe, Dapple/1F1B, interleaved.

A schedule is, per pipeline stage, an ordered list of ``Task``s. The
hierarchical modeler turns these into timed activities; the same lists
drive the replay oracle. ``interleaved`` (Megatron interleaved-1F1B,
beyond the paper) assigns ``vpp`` virtual stage chunks per device.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Task:
    phase: str          # "F" | "B"
    micro: int
    chunk: int = 0      # virtual stage chunk (interleaved only)


def gpipe(pp: int, m: int) -> List[List[Task]]:
    """All forwards, then all backwards in reverse micro order."""
    return [[Task("F", i) for i in range(m)]
            + [Task("B", i) for i in reversed(range(m))]
            for _ in range(pp)]


def one_f_one_b(pp: int, m: int) -> List[List[Task]]:
    """Dapple / PipeDream-flush: warmup F, steady 1F1B, cooldown B."""
    out = []
    for d in range(pp):
        w = min(m, pp - 1 - d)
        tasks: List[Task] = [Task("F", i) for i in range(w)]
        nf, nb = w, 0
        for _ in range(m - w):
            tasks.append(Task("F", nf)); nf += 1
            tasks.append(Task("B", nb)); nb += 1
        tasks.extend(Task("B", i) for i in range(nb, m))
        out.append(tasks)
    return out


def interleaved(pp: int, m: int, vpp: int) -> List[List[Task]]:
    """Interleaved 1F1B with vpp virtual chunks per device (simplified
    Megatron schedule: warmup proportional to vpp, round-robin chunks)."""
    if vpp == 1:
        return one_f_one_b(pp, m)
    out = []
    total_f = m * vpp
    for d in range(pp):
        # Megatron warmup count for interleaved 1F1B
        w = min(total_f, (pp - d - 1) * 2 + (vpp - 1) * pp)
        # forward dispatch order: groups of pp microbatches, chunk-major
        fseq = []
        for base in range(0, m, pp):
            for c in range(vpp):
                for i in range(base, min(base + pp, m)):
                    fseq.append((c, i))
        # backward order: same micro groups, chunks in REVERSE (deepest
        # pipeline position drains first)
        bseq = []
        for base in range(0, m, pp):
            for c in reversed(range(vpp)):
                for i in range(base, min(base + pp, m)):
                    bseq.append((c, i))
        tasks: List[Task] = [Task("F", i, c) for (c, i) in fseq[:w]]
        nf, nb = w, 0
        while nf < total_f:
            c, i = fseq[nf]; tasks.append(Task("F", i, c)); nf += 1
            c, i = bseq[nb]; tasks.append(Task("B", i, c)); nb += 1
        while nb < total_f:
            c, i = bseq[nb]; tasks.append(Task("B", i, c)); nb += 1
        out.append(tasks)
    return out


def forward_only(pp: int, m: int) -> List[List[Task]]:
    """Serving schedule: every stage runs the m pipelined work units
    (prefill requests / decode steps) forward-only, in order. The
    scenario's event graph carries the inter-unit dependencies (p2p
    activations; decode's token feedback + arrival floors)."""
    return [[Task("F", i) for i in range(m)] for _ in range(pp)]


def build_schedule(name: str, pp: int, m: int, vpp: int = 1
                   ) -> List[List[Task]]:
    if name == "gpipe":
        return gpipe(pp, m)
    if name in ("1f1b", "dapple"):
        return one_f_one_b(pp, m)
    if name == "interleaved":
        return interleaved(pp, m, vpp)
    if name == "pipedream":
        return pipedream(pp, m)
    raise ValueError(f"unknown schedule {name!r}")


def pipedream(pp: int, m: int) -> List[List[Task]]:
    """Asynchronous pipeline (PipeDream) schedule — paper §7 discussion:
    "the schedule in pipeline parallelism modeling can still be
    established only without a global synchronize event".

    Steady-state 1F1B without the flush: after warmup every stage
    alternates F/B indefinitely; we model one epoch of m microbatches.
    The DP gradient sync event is omitted by the modeler when
    ``Strategy.schedule == "pipedream"`` (weights update asynchronously
    per device).
    """
    out = []
    for d in range(pp):
        w = min(m, pp - d)              # deeper warmup than sync 1F1B
        tasks: List[Task] = [Task("F", i) for i in range(w)]
        nf, nb = w, 0
        while nb < m:
            if nf < m:
                tasks.append(Task("B", nb)); nb += 1
                tasks.append(Task("F", nf)); nf += 1
            else:
                tasks.append(Task("B", nb)); nb += 1
        out.append(tasks)
    return out
