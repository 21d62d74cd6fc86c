"""repro_torch.search — the part of strategy search the serving path
needs: the memory model and pruning bounds (:mod:`.prune`)."""
from repro_torch.search.prune import (HBM_BUDGET, estimate_memory,
                                      hbm_headroom, memory_feasible,
                                      work_lower_bound)

__all__ = ["HBM_BUDGET", "estimate_memory", "hbm_headroom",
           "memory_feasible", "work_lower_bound"]
