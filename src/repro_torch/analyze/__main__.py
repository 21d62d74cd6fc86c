"""CLI for the static analyzers.

``python -m repro_torch.analyze graph [--smoke|--full] [--cluster NAME]``
    Build every in-tree matrix cell (train + serving + degraded) on
    the cluster's analytical provider and run the full graph verifier
    over each engine, each perturbation, one compiled mega-batch over
    all engines, and the static HBM-capacity check per cell. Exit 1 on
    any finding. Host numpy only: the program is compiled on the CPU
    and never evaluated, so no card is needed.

``python -m repro_torch.analyze lint <paths...>``
    Run the AST contract linter over files/directories. Exit 1 on any
    finding.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from repro_torch.analyze.findings import VERIFY_ENV, Finding


def _cmd_graph(args: argparse.Namespace) -> int:
    # constructions below are verified explicitly so ALL findings are
    # collected; disable the raising construction-time hook.
    os.environ[VERIFY_ENV] = "0"
    from repro_torch.analyze.graph import (verify_cell_memory,
                                           verify_engine, verify_megabatch,
                                           verify_perturbation)
    from repro_torch.core.costmodel import get_cluster
    from repro_torch.core.megabatch import MegaBatch
    from repro_torch.core.profiler import provider_for
    from repro_torch.core.scenario import TRAIN
    from repro_torch.validate.build_cache import BuildCache
    from repro_torch.validate.degraded import degraded_matrix
    from repro_torch.validate.sweep import (full_matrix, serving_matrix,
                                            smoke_matrix)

    cluster = get_cluster(args.cluster)
    # the analytical provider of the cluster's chip (the reference's
    # for its presets, the Hopper curve for an H100 target)
    provider = provider_for(cluster)
    cache = BuildCache(provider)
    cells = smoke_matrix() + serving_matrix()
    if args.full:
        cells += full_matrix()

    findings: List[Finding] = []
    engines = []
    n_checked = 0
    for cell in cells:
        scenario = getattr(cell, "scenario", TRAIN)
        eng = cache.engine_for(cell)
        engines.append(eng)
        fs = verify_engine(eng)
        micro = scenario.microbatch_size(cell.strategy, cell.global_batch)
        fs += verify_cell_memory(
            cell.config(), cell.strategy, micro, cell.seq,
            cluster.chip.hbm_bytes, scenario=scenario)
        findings += [Finding(f.rule, f.message,
                             f"{cell.label()} | {f.where}")
                     for f in fs]
        n_checked += 1

    for dcell in degraded_matrix():
        eng = cache.engine_for(dcell)
        fs = verify_engine(eng)
        fs += verify_perturbation(dcell.perturb, dcell.strategy)
        findings += [Finding(f.rule, f.message,
                             f"{dcell.label()} | {f.where}")
                     for f in fs]
        n_checked += 1

    # compiled on the host and verified, never evaluated: no card needed
    mb = MegaBatch(engines, device="cpu")
    mb_findings = verify_megabatch(mb)
    findings += mb_findings
    print(f"repro_torch.analyze graph: {n_checked} cells + 1 mega-batch "
          f"program (K={mb.K}, T={mb.T}) on {cluster.name}")
    return _report(findings)


def _cmd_lint(args: argparse.Namespace) -> int:
    from repro_torch.analyze.lint import lint_paths
    findings = lint_paths(args.paths)
    print(f"repro_torch.analyze lint: {', '.join(args.paths)}")
    return _report(findings)


def _report(findings: List[Finding]) -> int:
    for f in findings:
        print(f"  {f}")
    if findings:
        print(f"FAIL: {len(findings)} finding(s)")
        return 1
    print("PASS: 0 findings")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="DistSim static analysis (graph verifier + linter)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("graph", help="verify the in-tree matrices' "
                                     "event graphs")
    g.add_argument("--smoke", action="store_true",
                   help="smoke + serving + degraded matrices (default)")
    g.add_argument("--full", action="store_true",
                   help="additionally sweep the nightly full_matrix()")
    g.add_argument("--cluster", default="a40-cluster",
                   help="cluster registry name (default: a40-cluster)")
    g.set_defaults(fn=_cmd_graph)

    lt = sub.add_parser("lint", help="AST contract linter")
    lt.add_argument("paths", nargs="+", help="files or directories")
    lt.set_defaults(fn=_cmd_lint)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
