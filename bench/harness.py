"""The benchmark's shared machinery: finding a cell's files by name,
the program's configuration and options from a configuration file, the
device's description, the modules that must not be loaded, and the
result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. Each is a file of its own under
``bench/``: ``configs/<config>.json``, ``traffic/<traffic>.json``, and
the limits of the comparison that decides ``correct``,
``limits/<cell>.json``. The mix's ``kind`` picks its driver,
``kinds/<kind>.py``; each per-layer metric is read by
``metrics/<metric>.py`` or, where that file is absent, by the reader of
the name's first part (``metrics/mfu.py`` reads ``mfu.train`` and
``mfu.prefill``, by the cell's kind). Nothing here names a cell.

The program's configuration is its registered ``ArchConfig`` with the
file's numbers put in (:func:`port_config`). A file may state three
keys beyond them: ``head_dim`` and ``qk_norm``, passed under those
names, and ``moe`` with its ``capacity_factor``, ``None`` (routing
without a capacity) included. Where ``ArchConfig`` has no field of a
key the file states, the port does not take that key yet, and
:func:`port_config` raises a ``ValueError`` that names it rather than
run a model other than the file's.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that no run may have loaded once its window closes:
#: the JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return read_json(path)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, workload: str, base: Path = BENCH) -> Cell:
    """The cell ``workload`` of ``manifest``, its files read from
    ``base``; a cell with no limits file yet gets no limits (and cannot
    be run: its outputs would go unchecked)."""
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in the manifest")
    limits = base / "limits" / f"{workload}.json"
    return Cell(
        name=workload, config_name=entry["config"],
        config=read_json(base / "configs" / f"{entry['config']}.json"),
        traffic=read_json(base / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(limits) if limits.exists() else {},
        chips=entry["chips"],
        end_to_end=[m for m in manifest["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)])


def kind_module(cell: Cell):
    return importlib.import_module(f"bench.kinds.{cell.kind}")


def metric_path(name: str) -> Path:
    """``metrics/<name>.py``, or else that of the name's first part."""
    path = BENCH / "metrics" / f"{name}.py"
    return path if path.exists() else \
        BENCH / "metrics" / f"{name.split('.')[0]}.py"


def metric_reader(name: str):
    """The ``read`` of the metric's file (:func:`metric_path`)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


#: keys a configuration file may state beyond the registered config's
#: numbers, each passed to the port under its own name
OPTIONAL_KEYS = ("head_dim", "qk_norm")


def port_fields(cfg: dict) -> dict:
    """The ``ArchConfig`` fields that the configuration file sets, by
    name."""
    from repro_torch.configs.base import MoEConfig
    moe = cfg.get("moe")
    fields = dict(
        n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
        d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        sliding_window=cfg.get("sliding_window"),
        rope_theta=cfg["rope_theta"], qkv_bias=cfg.get("qkv_bias", False),
        tie_embeddings=cfg.get("tie_embeddings", False),
        moe=MoEConfig(**moe) if moe else None)
    fields.update({k: cfg[k] for k in OPTIONAL_KEYS if k in cfg})
    return fields


def port_config(cfg: dict, base=None):
    """The port's ``ArchConfig`` (or ``base``, a config of the same
    kind) with the configuration file's numbers (:func:`port_fields`);
    a ``ValueError`` where the config has no field for one of them."""
    if base is None:
        from repro_torch.configs.base import get_config
        base = get_config(cfg["arch"])
    fields = port_fields(cfg)
    have = {f.name for f in dataclasses.fields(base)}
    for key in fields:
        if key not in have:
            raise ValueError(
                f"the configuration file states {key!r}, which the port's "
                f"{type(base).__name__} does not take yet")
    return dataclasses.replace(base, **fields)


def model_options(cfg: dict, kind: str):
    """The port's ``ModelOptions`` for a traffic kind: the configuration's
    dtype and its options for that kind."""
    from repro_torch.models.layers import ModelOptions

    from bench import weights
    return ModelOptions(dtype=weights.dtype_of(cfg),
                        **cfg.get("options", {}).get(kind, {}))


def loaded_forbidden() -> List[str]:
    """Forbidden top-level modules in ``sys.modules``, by whole name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, peak: int, chips: int) -> dict:
    import torch
    return {"platform": "gpu" if torch.device(device).type == "cuda"
            else "cpu",
            "kind": torch.cuda.get_device_name(0)
            if torch.device(device).type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}


def memory_peak(device) -> int:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()
    return 0


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def per_layer_metrics(cell: Cell, summary) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(summary, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def held(name: str, value: float, limit: Optional[float]) -> dict:
    """One number compared, beside its limit: it passes when it is not
    above the limit. A limit of ``None`` marks a number that is read and
    printed but not compared."""
    return {"name": name, "value": value, "limit": limit,
            "ok": limit is None or bool(value == value and value <= limit)}


def result(cell: Cell, checks: List[dict], attempted: int, failed: int,
           metrics: Dict[str, dict], device: dict,
           breakdown: Optional[dict] = None) -> dict:
    """The result line: the contract's keys, then the numbers compared
    with their limits, last."""
    out = {"correct": bool(checks) and all(c["ok"] for c in checks)
           and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def breakdown_of(summary) -> dict:
    return {"device_ops": [[n, s] for n, s in summary.device_ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}


def relative_gap(a: float, b: float, base: float) -> float:
    return abs(a - b) / base if base > 0 else float("inf")
