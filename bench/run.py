"""Run one cell of the benchmark on this machine's card and print its
result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files by name (``bench/harness.py``), then the cell's
traffic driver (``bench/kinds/<kind>.py``) makes the weights and the
traffic from the seed, warms up, runs the timed window and checks the
timed path's outputs against the plain reference. The last line of
standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error. Exits 3 without enough
CUDA devices and 4 if the JAX stack or the JAX package was loaded, in
both cases printing no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: every build and kernel cache the run may fill, inside the checkout
CACHES = {"REPRO_TORCH_BUILD_DIR": "build/repro_torch_kernels",
          "TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": "build/bench_cache/triton",
          "TORCHINDUCTOR_CACHE_DIR": "build/bench_cache/inductor",
          "CUDA_CACHE_PATH": "build/bench_cache/cuda"}


def environment() -> None:
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    from bench import harness
    cell = harness.resolve(harness.load_manifest(), args.workload)
    if not cell.limits:
        print(f"{args.workload} has no limits file: its outputs cannot be "
              f"checked", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out = harness.kind_module(cell).run(cell, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T0)
    found = harness.loaded_forbidden()
    if found:
        print(f"modules that the run must not load were loaded: {found}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
