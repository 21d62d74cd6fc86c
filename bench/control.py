"""Readings that the limits of a cell's comparison are set from.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 2 \
        [--out readings.jsonl]

For each of ``--seeds``, a run of the cell (a short window) and the
numbers its comparison reads: the lower readings. For each of
``--control-seeds``, the control: the reference put in the program's
place and computed in float8 (``decoder.Numerics("fp8")``), read by the
same comparison against the float32 reference. For each of
``--fault-seeds``, a run with each fault of ``bench/faults.py`` planted
under the timed path. One JSON line per reading, on standard output and
appended to ``--out``. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def values(checks) -> dict:
    return {k: v["value"] for k, v in checks.items()} if isinstance(
        checks, dict) else {c["name"]: c["value"] for c in checks}


def control_readings(cell, seed: int, device) -> dict:
    from bench import traffic, weights
    from bench.kinds import prefill, train
    from bench.reference import decoder
    fp8 = decoder.Numerics("fp8")
    batches = traffic.pool(cell.traffic, cell.config, seed, device)
    if cell.kind == "train":
        want = train.reference(cell, seed, device, batches)
        got = train.reference(cell, seed, device, batches, fp8)
        return values(train.compare(cell, got, want))
    decoder.no_tf32()
    w = weights.make(cell.config, seed, device)
    errs = []
    for i in prefill.sample(cell.traffic, seed):
        tokens = batches[(cell.traffic["warmup"] + i) % len(batches)]
        want = decoder.forward(cell.config, w, tokens["tokens"])
        got = decoder.forward(cell.config, w, tokens["tokens"], fp8)
        errs.append(prefill.position_errors(got, want))
        del want, got
    import torch
    return values(prefill.compare(cell, torch.cat(errs, dim=1)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import gc

    import torch

    from bench import faults, harness
    cell = harness.resolve(harness.load_manifest(), args.workload)
    device = "cuda"
    kind = harness.kind_module(cell)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for seed in seeds(args.seeds):
        fresh()
        t = time.perf_counter()
        out = kind.run(cell, seed, args.seconds, False, device, t)
        emit({"cell": cell.name, "reading": "program", "seed": seed,
              "numbers": values(out["checks"]), "metrics": out["metrics"],
              "peak": out["device"]["memory_peak_bytes"],
              "seconds": time.perf_counter() - t})
    for seed in seeds(args.control_seeds):
        fresh()
        t = time.perf_counter()
        emit({"cell": cell.name, "reading": "control", "seed": seed,
              "numbers": control_readings(cell, seed, device),
              "seconds": time.perf_counter() - t})
    for seed in seeds(args.fault_seeds):
        for name, fault in faults.BY_KIND[cell.kind].items():
            if name == "half_batch" and cell.traffic["batch"] < 2:
                continue
            fresh()
            t = time.perf_counter()
            out = kind.run(cell, seed, args.seconds, False, device, t,
                           fault=fault)
            emit({"cell": cell.name, "reading": f"fault:{name}",
                  "seed": seed, "numbers": values(out["checks"]),
                  "seconds": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
