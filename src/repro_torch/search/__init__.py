"""repro_torch.search — cached, pruned, multi-cluster strategy search.

The paper's §6 use-case as a subsystem, scored on the card:

    from repro_torch.search import SearchEngine, search_report
    engine = SearchEngine(cfg, clusters=[H100_CLUSTER, A40_CLUSTER])
    result = engine.search(n_devices=64, global_batch=64, seq=512)
    print(format_report(search_report(result)))

``repro_torch.core.search.grid_search`` remains as a deprecated
naive-compatible wrapper over this engine.
"""
from repro_torch.search.cache import ProfileCache
from repro_torch.search.engine import (SearchEngine, SearchEntry,
                                       SearchResult, SearchStats,
                                       pareto_frontier)
from repro_torch.search.prune import (HBM_BUDGET, estimate_memory,
                                      hbm_headroom, memory_feasible,
                                      work_lower_bound)
from repro_torch.search.report import (format_report, format_table,
                                       search_report)
from repro_torch.search.space import Candidate, enumerate_candidates

__all__ = [
    "ProfileCache", "SearchEngine", "SearchEntry", "SearchResult",
    "SearchStats", "pareto_frontier", "HBM_BUDGET", "estimate_memory",
    "hbm_headroom", "memory_feasible", "work_lower_bound",
    "format_report", "format_table", "search_report", "Candidate",
    "enumerate_candidates",
]
