"""Paper §6 use-case: automatic hybrid-parallel strategy search.

Sweeps (MP, PP, DP, microbatches, schedule) for a model WITHOUT touching
a cluster — the Fig. 12 / Table 2 workflow — using the cached, pruned
search engine, whose mega-batch runs on ``--device``:

* every candidate shares one profile cache per cluster, so unique
  events are cost-evaluated once per search, not once per candidate;
* memory-infeasible candidates are skipped, and candidates whose
  work lower bound already loses to the best known strategy are pruned
  before full timeline construction;
* pass several ``--clusters`` to get per-cluster rankings plus a
  cross-cluster Pareto frontier over (batch time, HBM headroom,
  profiling cost).

    PYTHONPATH=src python -m repro_torch.examples.strategy_search \\
        [--devices 16] [--clusters a40-cluster,h100-cluster] [--no-prune] \\
        [--device cpu]

The top pick is re-checked against the replay oracle (jittered
discrete-event run), as the paper validates Table 2 on real hardware.
"""
import argparse

from repro_torch.configs.base import get_config
from repro_torch.core import DistSim, get_cluster
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.search import SearchEngine, format_report, search_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--arch", default="bert_exlarge")
    ap.add_argument("--clusters", default="a40-cluster",
                    help="comma-separated ClusterSpec names "
                         "(a40-cluster, h100-cluster, v5e-pod)")
    ap.add_argument("--no-prune", action="store_true",
                    help="simulate every candidate (cross-check mode)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    clusters = [get_cluster(n) for n in args.clusters.split(",")]
    engine = SearchEngine(cfg, clusters=clusters,
                          prune=not args.no_prune, check_memory=True,
                          device=args.device)
    result = engine.search(args.devices, args.global_batch, args.seq,
                           schedules=("1f1b", "gpipe", "interleaved"))

    print(f"{args.arch} on {args.devices} devices, "
          f"global batch {args.global_batch}, "
          f"clusters {[c.name for c in clusters]}\n")
    print(format_report(search_report(result, top=args.top)))

    best = result.best()
    if best is None:
        print("\nno feasible strategy found")
        return
    cluster = next(c for c in clusters if c.name == best.cluster)
    provider = engine.cache.provider(cluster)
    act = DistSim(cfg, best.strategy, args.global_batch, args.seq,
                  provider).simulate(seeds=0).result()
    print(f"\nreplay-verified best ({best.strategy.label()} on "
          f"{best.cluster}): {1 / act.batch_time:.2f} it/s "
          f"(predicted {best.iters_per_s:.2f})")


if __name__ == "__main__":
    main()
