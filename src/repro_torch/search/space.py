"""Strategy search space (paper §6).

Enumerates hybrid-parallel candidates (MP, PP, DP, microbatches,
schedule) for a fixed device count — the grid the paper sweeps in
Fig. 12 / Table 2. The enumeration order is deterministic and shared by
the cached engine and the naive baseline, so their rankings are
directly comparable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.events import Strategy


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search grid: a strategy plus its per-device
    microbatch size (derived from the global batch)."""
    strategy: Strategy
    microbatch: int

    def label(self) -> str:
        return (f"{self.strategy.label()}@m{self.strategy.microbatches}"
                f":{self.strategy.schedule}")


def powers_of_two(n: int) -> List[int]:
    out, p = [], 1
    while p <= n:
        out.append(p)
        p *= 2
    return out


def enumerate_candidates(n_devices: int, global_batch: int,
                         microbatches: Optional[Sequence[int]] = None,
                         schedules: Sequence[str] = ("1f1b",),
                         zero1_options: Sequence[bool] = (False,)
                         ) -> List[Candidate]:
    """All (mp, pp, dp, m, schedule[, zero1]) combos with power-of-two
    degrees whose product is exactly ``n_devices`` and whose microbatch
    count divides the per-replica batch."""
    out: List[Candidate] = []
    for mp in powers_of_two(n_devices):
        for pp in powers_of_two(n_devices // mp):
            dp = n_devices // (mp * pp)
            if mp * pp * dp != n_devices or global_batch % dp:
                continue
            per_replica = global_batch // dp
            mb_opts = microbatches or sorted({
                m for m in powers_of_two(per_replica)
                if m >= min(pp, per_replica)})
            for m in mb_opts:
                if per_replica % m:
                    continue
                for sch in schedules:
                    for z1 in zero1_options:
                        strat = Strategy(mp=mp, pp=pp, dp=dp,
                                         microbatches=m, schedule=sch,
                                         zero1=z1)
                        out.append(Candidate(strat, per_replica // m))
    return out
