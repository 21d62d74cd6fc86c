"""Search reporting: Table 2-style ranking + Pareto + cost accounting.

``search_report`` turns a :class:`SearchResult` into a plain dict
(JSON-serializable) consumed by ``examples/strategy_search.py`` and
``benchmarks/bench_search.py``; ``format_report`` renders it for a
terminal. ``format_table`` is the shared column renderer, also used by
``repro_torch.validate.report``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.search.engine import SearchEntry, SearchResult


def format_table(headers: Sequence[str], rows: Sequence[Sequence],
                 aligns: Optional[Sequence[str]] = None) -> List[str]:
    """Render a padded text table: header line + one line per row.
    ``aligns`` is per-column ``"<"``/``">"`` (default: right)."""
    cells = [[str(c) for c in row] for row in rows]
    aligns = list(aligns) if aligns else [">"] * len(headers)
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    def line(row):
        return " ".join(f"{c:{a}{w}s}"
                        for c, a, w in zip(row, aligns, widths)).rstrip()
    return [line(list(headers))] + [line(r) for r in cells]


def _row(rank: int, e: SearchEntry) -> Dict:
    return {
        "rank": rank,
        "strategy": e.strategy.label(),
        "schedule": e.strategy.schedule,
        "microbatches": e.strategy.microbatches,
        "cluster": e.cluster,
        "batch_time_s": e.batch_time,
        "iters_per_s": e.iters_per_s,
        "bubble_pct": 100.0 * e.bubble_fraction,
        "hbm_headroom_gb": e.hbm_headroom / 1e9,
        "profile_time_s": e.profile_time_s,
    }


def search_report(result: SearchResult, top: int = 10,
                  cluster: Optional[str] = None) -> Dict:
    """Structured summary: best strategy, Table 2 ranking, Pareto
    frontier, and the cache/pruning accounting that makes the cached
    engine ≥5x cheaper than naive per-candidate profiling."""
    ranking = result.ranking(cluster)
    st = result.stats
    # best/worst spread is a STRATEGY comparison (Table 2), so both
    # ends must come from the same cluster — on multi-cluster searches
    # the global ranking mixes hardware speeds.
    home = result.ranking(cluster or (ranking[0].cluster if ranking
                                      else None))
    report = {
        "best": _row(1, ranking[0]) if ranking else None,
        "ranking": [_row(i + 1, e) for i, e in enumerate(ranking[:top])],
        "worst": _row(len(home), home[-1]) if home else None,
        "speedup_best_vs_worst": (
            home[-1].batch_time / home[0].batch_time
            if len(home) > 1 else 1.0),
        "pareto": [_row(i + 1, e)
                   for i, e in enumerate(result.pareto)],
        "clusters": sorted(result.by_cluster),
        # full specs (ClusterSpec.to_dict round-trip), not names only —
        # a report over a custom cluster stays self-describing
        "cluster_specs": {name: spec.to_dict()
                          for name, spec in
                          sorted(result.cluster_specs.items())},
        "search": {
            "candidates": st.candidates,
            "evaluated": st.evaluated,
            "pruned_memory": st.pruned_memory,
            "pruned_bound": st.pruned_bound,
            "provider_evaluations": st.provider_evaluations,
            "cache_hits": st.cache_hits,
            "megabatch_lanes": st.megabatch_lanes,
            "wall_time_s": st.wall_time_s,
            "candidates_per_s": st.candidates_per_s,
        },
    }
    return report


def format_report(report: Dict) -> str:
    lines: List[str] = []
    s = report["search"]
    lines.append(
        f"searched {s['candidates']} candidates on "
        f"{len(report['clusters'])} cluster(s) in {s['wall_time_s']:.2f}s "
        f"({s['candidates_per_s']:.1f} cand/s): "
        f"{s['evaluated']} simulated, {s['pruned_memory']} OOM, "
        f"{s['pruned_bound']} bound-pruned")
    lines.append(
        f"profiling: {s['provider_evaluations']} cost evaluations, "
        f"{s['cache_hits']} cache hits")
    lines.append("")
    lines.extend(format_table(
        ["rank", "strategy", "sched", "micro", "cluster", "it/s",
         "bubble%", "hbm GB"],
        [[r["rank"], r["strategy"], r["schedule"], r["microbatches"],
          r["cluster"], f"{r['iters_per_s']:.2f}",
          f"{r['bubble_pct']:.1f}", f"{r['hbm_headroom_gb']:.1f}"]
         for r in report["ranking"]],
        aligns=(">", "<", "<", ">", "<", ">", ">", ">")))
    if report["worst"]:
        w = report["worst"]
        lines.append(
            f"WORST {w['strategy']} {w['schedule']} m={w['microbatches']} "
            f"{w['iters_per_s']:.3f} it/s — best/worst speedup "
            f"{report['speedup_best_vs_worst']:.2f}x (paper: 7.379x)")
    if report["pareto"]:
        lines.append("")
        lines.append("Pareto frontier (batch_time ↓, profiling cost ↓, "
                     "HBM headroom ↑):")
        for r in report["pareto"]:
            lines.append(
                f"  {r['strategy']:12s} {r['schedule']:10s} "
                f"m={r['microbatches']:<4d} {r['cluster']:12s} "
                f"{r['iters_per_s']:.2f} it/s  "
                f"headroom {r['hbm_headroom_gb']:.1f} GB  "
                f"profile {r['profile_time_s']*1e3:.1f} ms")
    return "\n".join(lines)
