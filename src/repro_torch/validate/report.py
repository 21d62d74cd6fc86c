"""Structured validation reports: JSON round-trip + terminal rendering.

``dump`` lowers a :class:`SweepResult` to a JSON-ready dict and
``load`` reconstructs an equal object (``load(dump(r)) == r``), which
is what lets goldens under ``tests/goldens/`` and the CI artifact
``validation_report.json`` share one format. ``format_validation_report``
renders the per-cell pass/fail table via the shared
:func:`repro_torch.search.report.format_table`.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Union

from repro_torch.core.events import Strategy
from repro_torch.core.scenario import scenario_from_dict
from repro_torch.search.report import format_table
from repro_torch.validate.metrics import CellMetrics
from repro_torch.validate.sweep import (CellResult, SweepResult, Thresholds,
                                        ValidationCell)

SCHEMA_VERSION = 1


def _enc_f(v: float):
    """Non-finite floats become strings ('inf', '-inf', 'nan') so the
    emitted file stays RFC-8259 JSON — a degenerate-replay report with
    infinite error must still parse in jq/JS, that's exactly the case
    it exists to surface."""
    return v if math.isfinite(v) else repr(v)


def _dec_f(v) -> float:
    return float(v) if isinstance(v, str) else v


def _enc_metrics(d: Dict[str, float]) -> Dict:
    return {k: _enc_f(v) for k, v in d.items()}


def _dec_metrics(d: Dict) -> Dict[str, float]:
    return {k: _dec_f(v) for k, v in d.items()}


def _cell_dict(c: CellResult) -> Dict:
    d = {
        "label": c.cell.label(),
        "arch": c.cell.arch,
        "smoke": c.cell.smoke,
        "xfail": c.cell.xfail,
        "strategy": c.cell.strategy.to_dict(),
        "global_batch": c.cell.global_batch,
        "seq": c.cell.seq,
        "seeds": list(c.seeds),
        "pred_batch_time": _enc_f(c.pred_batch_time),
        "replay_batch_times": [_enc_f(t) for t in c.replay_batch_times],
        "metrics": _enc_metrics(c.metrics.to_dict()),
        "per_seed": [_enc_metrics(m.to_dict()) for m in c.per_seed],
        "violations": list(c.violations),
        "passed": c.passed,
    }
    # scenario key only for serving cells: training reports/goldens
    # stay byte-identical to the pre-scenario schema
    if not c.cell.scenario.is_train:
        d["scenario"] = c.cell.scenario.to_dict()
    return d


def _cell_from_dict(d: Dict) -> CellResult:
    cell = ValidationCell(
        arch=d["arch"], strategy=Strategy.from_dict(d["strategy"]),
        global_batch=d["global_batch"], seq=d["seq"],
        smoke=d["smoke"], xfail=d["xfail"],
        scenario=scenario_from_dict(d.get("scenario")))
    return CellResult(
        cell=cell,
        metrics=CellMetrics.from_dict(_dec_metrics(d["metrics"])),
        per_seed=[CellMetrics.from_dict(_dec_metrics(m))
                  for m in d["per_seed"]],
        seeds=list(d["seeds"]),
        pred_batch_time=_dec_f(d["pred_batch_time"]),
        replay_batch_times=[_dec_f(t) for t in d["replay_batch_times"]],
        violations=list(d["violations"]))


def dump(result: SweepResult) -> Dict:
    """JSON-ready dict (lists only, no tuples — survives json round-trip)."""
    return {
        "schema": SCHEMA_VERSION,
        "cluster": result.cluster,
        "seeds": list(result.seeds),
        "jitter_sigma": result.jitter_sigma,
        "thresholds": result.thresholds.to_dict(),
        "cells": [_cell_dict(c) for c in result.cells],
        "passed": result.passed,
        "n_cells": len(result.cells),
        "n_failures": len(result.failures),
        "n_xpasses": len(result.xpasses),
    }


def load(obj: Union[Dict, str]) -> SweepResult:
    """Inverse of :func:`dump`; accepts the dict or its JSON string.
    Rejects other schema versions instead of default-filling fields —
    a stale golden/artifact must error, not silently mis-load."""
    d = json.loads(obj) if isinstance(obj, str) else obj
    if d.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"validation report schema {d.get('schema')!r} != "
            f"{SCHEMA_VERSION} — regenerate with "
            f"benchmarks/bench_validate.py")
    return SweepResult(
        cells=[_cell_from_dict(c) for c in d["cells"]],
        thresholds=Thresholds.from_dict(d["thresholds"]),
        cluster=d["cluster"], seeds=list(d["seeds"]),
        jitter_sigma=d["jitter_sigma"])


def dumps(result: SweepResult, indent: int = 2) -> str:
    # allow_nan=False: hard guarantee the artifact is strict JSON
    # (non-finite floats are string-encoded by dump)
    return json.dumps(dump(result), indent=indent, sort_keys=True,
                      allow_nan=False)


def save(result: SweepResult, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(result) + "\n")


def load_path(path: str) -> SweepResult:
    with open(path) as f:
        return load(json.load(f))


def format_validation_report(report: Union[Dict, SweepResult]) -> str:
    """Terminal rendering: threshold header + per-cell metric table."""
    d = dump(report) if isinstance(report, SweepResult) else report
    thr = d["thresholds"]
    lines = [
        f"validation sweep on {d['cluster']}: {d['n_cells']} cells, "
        f"seeds={d['seeds']}, jitter={100 * d['jitter_sigma']:.1f}%",
        f"thresholds: batch_time<{100 * thr['batch_time']:.0f}% "
        f"(worst seed <{100 * thr['batch_time_worst']:.0f}%) "
        f"activity<{100 * thr['activity']:.0f}% "
        f"stage<{100 * thr['stage']:.0f}% "
        f"utilization<{100 * thr['utilization']:.0f}% (paper §5: <4%/<5%)",
        "",
    ]
    rows = []
    for c in d["cells"]:
        m = _dec_metrics(c["metrics"])    # dump() string-encodes inf/nan
        status = "PASS" if c["passed"] else "FAIL"
        if c["xfail"]:
            status = "XPASS" if c["passed"] else "xfail"
        rows.append([
            c["label"], f"{100 * m['batch_time_error']:.2f}",
            f"{100 * m['worst_batch_time_error']:.2f}",
            f"{100 * m['activity_error_max']:.2f}",
            f"{100 * m['stage_error_max']:.2f}",
            f"{100 * m['utilization_delta_max']:.2f}",
            status + ("" if c["passed"] else
                      f" [{','.join(c['violations'])}]"),
        ])
    lines.extend(format_table(
        ["cell", "bt%", "bt_worst%", "act%", "stage%", "util%", "status"],
        rows, aligns=("<", ">", ">", ">", ">", ">", "<")))
    verdict = "PASSED" if d["passed"] else "FAILED"
    n_ok = sum(1 for c in d["cells"] if c["passed"])
    n_xfail = sum(1 for c in d["cells"] if c["xfail"] and not c["passed"])
    lines.append("")
    lines.append(f"{verdict}: {n_ok}/{d['n_cells']} cells within "
                 f"thresholds"
                 + (f", {n_xfail} xfail" if n_xfail else "")
                 + (f", {d['n_xpasses']} xpass" if d["n_xpasses"] else ""))
    return "\n".join(lines)
