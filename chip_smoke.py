#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once at the full width of gpt_145b
(80 layers, d_model 12288, d_ff 49152): ``DistSim.serve()`` answers the
whole 1f1b+gpipe power-of-two strategy grid for 1024 devices (global
batch 2048, seq 2048) as ONE mega-batch program scored by the
hand-written Hopper scan kernel, cold and then warm. Around that it

* builds the kernel from the sources in the checkout (``nvcc``, sm_90a);
* holds the kernel against its plain PyTorch version — bit-identical
  ``ends`` and ``starts`` — on seeded random programs and on the
  full-width program, and times both there;
* shows that the serve path launched the kernel (launch count reset
  just before the path, read just after);
* profiles the unique events of one full-width pipeline stage with
  ``TorchMeasuredProvider`` on the card.

Every phase prints one JSON object on a line of its own (``env``,
``build``, ``kernels``, ``profile``, ``serve``); the last line is
``{"ok": true, "device": {...}}``. Any failed check raises: the run
exits non-zero and prints no last line. There is no CPU mode — without
a CUDA device the script exits with code 2 before doing anything.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM datasheet peaks used for the kernel's bound
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 33.5e12          # vector fp64 (no tensor cores used)

ARCH = "gpt_145b"
N_DEVICES, GLOBAL_BATCH, SEQ = 1024, 2048, 2048
MAX_MP, MAX_PP = 64, 64             # <= 96 heads, <= 80 layers
CLUSTER = "h100-cluster"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def powers_of_two(n: int):
    return [1 << i for i in range(n.bit_length()) if (1 << i) <= n]


def strategy_grid(Strategy):
    """Every (mp, pp, dp, microbatches, schedule) with power-of-two
    degrees whose product is N_DEVICES and whose microbatch count
    divides the per-replica batch — the grid a strategy search sweeps."""
    out = []
    for mp in powers_of_two(N_DEVICES):
        for pp in powers_of_two(N_DEVICES // mp):
            dp = N_DEVICES // (mp * pp)
            if mp > MAX_MP or pp > MAX_PP or GLOBAL_BATCH % dp:
                continue
            per_replica = GLOBAL_BATCH // dp
            for m in powers_of_two(per_replica):
                if m < min(pp, per_replica) or per_replica % m:
                    continue
                for schedule in ("1f1b", "gpipe"):
                    out.append(Strategy(mp=mp, pp=pp, dp=dp,
                                        microbatches=m, schedule=schedule))
    return out


def random_program(seed: int, K: int, max_len: int, device):
    """A random valid program in the accelerator layout, laid out as the
    compiler lays one out: slot 0 the constant dummy, one contiguous
    slot range per lane, dependencies only on the dummy or on slots the
    same lane wrote earlier, padding reading the dummy and writing the
    trash slot."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, size=K)
    lens[rng.integers(K)] = max_len
    T, total = int(lens.max()), int(lens.sum())
    out = np.full((T, K), total + 1, dtype=np.int32)
    dep = np.zeros((T, K, 3), dtype=np.int32)
    delay = np.zeros((T, K, 3))
    dur = np.zeros((T, K))
    base = 1
    for k, n in enumerate(int(n) for n in lens):
        slots = base + rng.permutation(n)
        out[:n, k] = slots
        steps = np.arange(n)
        for d in range(3):
            earlier = (rng.random(n) * steps).astype(np.int64)   # < step
            use = (rng.random(n) < 0.7) & (steps > 0)
            dep[:n, k, d] = np.where(use, slots[earlier], 0)
            delay[:n, k, d] = rng.random(n) * 1e-3
        dur[:n, k] = rng.random(n) * 1e-2
        base += n
    planes = [torch.from_numpy(a).to(device) for a in (out, dep, delay, dur)]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(device)
    return planes, total + 2, lengths


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max().item()) if a.numel() else 0.0


def timed_ms(fn, reps: int) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_env() -> dict:
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    from repro_torch.kernels.build import find_nvcc
    nvcc = run_text([find_nvcc(), "--version"]).splitlines()[-2:]
    return {"phase": "env", "nvidia_smi": smi,
            "python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": " / ".join(nvcc)}


def phase_build(scan) -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    scan._library()
    seconds = time.perf_counter() - t0
    path, nvcc_seconds = build.BUILD_LOG["megabatch_scan"]
    return {"phase": "build", "kernel": "megabatch_scan",
            "source": "src/repro_torch/kernels/csrc/megabatch_scan.cu",
            "flags": list(build.NVCC_FLAGS), "seconds": seconds,
            "nvcc_seconds": nvcc_seconds,
            "directory": os.path.relpath(os.path.dirname(path), HERE),
            "library": os.path.basename(path)}


def check_random_programs(scan, device) -> list:
    """Kernel vs plain version on seeded random programs, ragged and
    walking the padding."""
    rows = []
    for seed, K, max_len in ((1, 1, 1), (2, 33, 257), (3, 444, 700),
                             (4, 1000, 64)):
        planes, n_slots, lengths = random_program(seed, K, max_len, device)
        for ragged in (True, False):
            ln = lengths if ragged else None
            ek, sk = scan.scan_steps(*planes, n_slots, backend="cuda",
                                     lengths=ln)
            torch.cuda.synchronize()
            ep, sp = scan.scan_steps(*planes, n_slots, backend="torch",
                                     lengths=ln)
            torch.cuda.synchronize()
            same = bool(torch.equal(ek, ep) and torch.equal(sk, sp))
            rows.append({"seed": seed, "K": K, "T": int(planes[0].shape[0]),
                         "ragged": ragged, "bit_identical": same})
            check(same, f"kernel != plain version on random program "
                        f"seed={seed} K={K} ragged={ragged}")
            check(float(ek.max()) > 0.0, "random program evaluated to zeros")
    return rows


def phase_serve(port, store_mod, scan, store_dir: str):
    """The main path: cold batch, warm batch, and a second server over
    the warmed store. Returns the JSON line, the compiled program and
    the launches the path made."""
    grid = strategy_grid(port.Strategy)
    queries = [store_mod.ServeQuery(ARCH, s, global_batch=GLOBAL_BATCH,
                                    seq=SEQ, cluster=CLUSTER) for s in grid]
    log(f"serve: {len(queries)} strategy queries, {ARCH} full width")

    scan.LAUNCHES = 0                       # just before the main path
    server = port.DistSim.serve(store_dir, backend="cuda")   # on the card
    t0 = time.perf_counter()
    cold = server.answer_batch(queries)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    snap_cold = server.snapshot()
    log(f"serve: cold batch {cold_s:.1f}s")

    t0 = time.perf_counter()
    warm = server.answer_batch(queries)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    snap_warm = server.snapshot()
    log(f"serve: warm batch {warm_s:.3f}s")

    # a new server over the warmed store: persisted events and builds
    subset = sorted(range(len(queries)),
                    key=lambda i: (grid[i].pp * grid[i].microbatches, i))[:64]
    second = port.DistSim.serve(store_dir, backend="cuda")
    t0 = time.perf_counter()
    again = second.answer_batch([queries[i] for i in subset])
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    snap_second = second.snapshot()
    launches = scan.LAUNCHES                # just after the main path

    (mb,) = server._programs.values()
    check(mb.K == len(queries) and mb.K >= 256, f"K = {mb.K} lanes")
    check(mb.T >= 16384, f"T = {mb.T} steps")
    check(mb.device.type == "cuda" and mb.resolve_backend("auto") == "cuda",
          "program is not on the card")
    check(launches == 3, f"serve path launched the kernel {launches}x, "
                         f"expected 3 (cold, warm, second server)")

    bt_cold = np.asarray([a.batch_time for a in cold])
    bt_warm = np.asarray([a.batch_time for a in warm])
    check(bool(np.all(np.isfinite(bt_cold)) and np.all(bt_cold > 0)),
          "batch times are not finite and positive")
    log("serve: numpy reference backend on the same program")
    t0 = time.perf_counter()
    ref = mb.predict("numpy")
    numpy_s = time.perf_counter() - t0
    check(np.array_equal(bt_cold, ref.batch_times),
          "cuda batch times differ from the numpy backend (cold)")
    check(np.array_equal(bt_warm, ref.batch_times),
          "cuda batch times differ from the numpy backend (warm)")
    check(np.array_equal(np.asarray([a.batch_time for a in again]),
                         ref.batch_times[subset]),
          "second server's answers differ")
    # the repo's own oracle: per-query DistSim.simulate() (small lanes)
    for i in subset[:8]:
        sim = port.DistSim(port_config(ARCH), grid[i], GLOBAL_BATCH, SEQ)
        check(sim.simulate().batch_time == cold[i].batch_time,
              f"answer {i} differs from DistSim.simulate()")

    ev_cold = snap_cold["clusters"][CLUSTER]["evaluations"]
    ev_warm = snap_warm["clusters"][CLUSTER]["evaluations"]
    check(ev_cold > 0, "cold pass evaluated no event")
    check(ev_warm == ev_cold, "warm pass evaluated events")
    check(snap_warm["programs_reused"] == 1, "warm pass recompiled")
    check(snap_second["clusters"][CLUSTER]["evaluations"] == 0,
          "a server over the warmed store evaluated events")
    check(snap_second["store"]["builds_loaded"] > 0,
          "a server over the warmed store loaded no build")

    best = int(np.argmin(bt_cold))
    line = {
        "phase": "serve", "arch": ARCH, "devices": N_DEVICES,
        "global_batch": GLOBAL_BATCH, "seq": SEQ, "cluster": CLUSTER,
        "backend": "cuda", "K": mb.K, "T": mb.T, "n_slots": mb.n_slots,
        "live_steps": int(mb._len.sum()),
        "device_bytes": mb.device_bytes(),
        "cold_seconds": cold_s, "warm_seconds": warm_s,
        "second_server_seconds": second_s,
        "second_server_queries": len(subset),
        "numpy_backend_seconds": numpy_s,
        "cold_evaluations": ev_cold,
        "warm_evaluations": ev_warm - ev_cold,
        "second_server_evaluations": 0,
        "programs_reused": snap_warm["programs_reused"],
        "kernel_launches": launches,
        "bit_identical_to_numpy": True,
        "feasible": int(sum(a.feasible for a in cold)),
        "best": {"strategy": grid[best].label(),
                 "microbatches": grid[best].microbatches,
                 "schedule": grid[best].schedule,
                 "batch_time": float(bt_cold[best])},
    }
    return line, mb, launches


def port_config(name: str):
    from repro_torch.configs.base import get_config
    return get_config(name)


def phase_kernels(scan, mb, launches: int, random_rows: list) -> dict:
    """K1 against its plain version on the full-width program, with
    times and the bound computed from this run's inputs."""
    p = mb.device_planes()
    args = (p["out"], p["dep"], p["delay"], p["dur"], mb.n_slots)

    def kernel():
        return scan.scan_steps(*args, backend="cuda", lengths=p["lengths"])

    ek, sk = kernel()
    torch.cuda.synchronize()                # a fault would surface here
    ms = timed_ms(kernel, reps=3)
    log(f"kernels: kernel {ms:.2f} ms on the full-width program; "
        f"running the plain version ({mb.T} steps)")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ep, sp = scan.scan_steps(*args, backend="torch", lengths=p["lengths"])
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err = max(max_abs_diff(ek, ep), max_abs_diff(sk, sp))
    same = bool(torch.equal(ek, ep) and torch.equal(sk, sp))
    check(same and err == 0.0,
          f"kernel != plain version on the full-width program "
          f"(max abs err {err})")
    # against the host reference too, slot for slot
    ref_ends, ref_starts = mb._eval_numpy()
    check(np.array_equal(ek.cpu().numpy(), ref_ends)
          and np.array_equal(sk.cpu().numpy()[1: mb.total + 1],
                             ref_starts[1: mb.total + 1]),
          "kernel != numpy reference on the full-width program")

    # bound: every live step's row read once (out 4 + dep 12 + delay 24
    # + dur 8 bytes), lengths read once, ends and starts written once;
    # 3 adds + 2 max + 1 add per live step in fp64
    live = int(mb._len.sum())
    nbytes = live * 48 + mb.K * 4 + 2 * mb.n_slots * 8
    flops = live * 6
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP64_FLOPS_PER_S * 1e3
    return {"kernels": [{
        "name": "megabatch_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/megabatch_scan.cu",
        "replaces": "src/repro/kernels/megabatch_scan.py:91",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "dtype": "float64", "tolerance": "bit-identical (0.0)",
        "shape": {"T": mb.T, "K": mb.K, "n_slots": mb.n_slots,
                  "live_steps": live},
        "bound_bytes": nbytes, "chain_steps": mb.T,
        "ns_per_chain_step": ms * 1e6 / mb.T,
        "random_programs": random_rows,
    }]}


def phase_profile(port) -> dict:
    """TorchMeasuredProvider on the card over the unique events of one
    full-width gpt_145b pipeline stage (8M16P1D, seq 2048)."""
    from repro_torch.core.events import build_stage_events, stage_event_set
    cfg = port_config(ARCH)
    strat = port.Strategy(mp=8, pp=16, dp=1, microbatches=16)
    micro = 4                               # global batch 64
    provider = port.TorchMeasuredProvider(
        port.H100_CLUSTER, reps=3, dtype=torch.bfloat16, tf32=False)
    stages = build_stage_events(cfg, strat, micro, SEQ,
                                provider.cluster.devices_per_island)
    events = sorted(stage_event_set(stages[1:2]),
                    key=lambda e: (e.kind, e.name))
    t0 = time.perf_counter()
    times = {e: provider.time(e) for e in events}
    seconds = time.perf_counter() - t0
    check(all(np.isfinite(t) and t >= 0 for t in times.values()),
          "a profiled event time is not finite")
    compute = [e for e in events if e.kind == "compute" and e.gemms]
    check(bool(compute), "the stage has no compute event")
    check(all(times[e] > 0 for e in compute), "a GEMM group took no time")
    g = max((g for e in compute for g in e.gemms), key=lambda g: g.flops)
    dims = ((g.m, g.n, g.k),)
    t_group = provider._time_group(dims)    # GEMM + silu epilogue
    (a, b), = provider._inputs(dims)
    torch.matmul(a, b)
    t_mm = min(timed_ms(lambda: torch.matmul(a, b), reps=1)
               for _ in range(5)) * 1e-3
    analytic = port.HopperAnalyticalProvider(port.H100_CLUSTER)
    ratio = [times[e] / analytic.time(e) for e in compute]
    return {"phase": "profile", "arch": ARCH, "strategy": strat.label(),
            "stage": 1, "microbatch": micro, "seq": SEQ,
            "dtype": "bfloat16", "tf32": False, "reps": provider.reps,
            "events": len(events), "compute_events": len(compute),
            "evaluations": provider.stats.evaluations,
            "gemm_groups_timed": len(provider._group_cache),
            "seconds": seconds,
            "stage_compute_seconds": float(sum(times[e] for e in compute)),
            "largest_gemm": {"m": g.m, "n": g.n, "k": g.k},
            "largest_gemm_with_epilogue_tflops": g.flops / t_group / 1e12,
            "largest_gemm_matmul_only_tflops": g.flops / t_mm / 1e12,
            "measured_over_analytical_min": float(min(ratio)),
            "measured_over_analytical_max": float(max(ratio))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False. There is no CPU mode.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch.core as port
    import repro_torch.store as store_mod
    from repro_torch.kernels import megabatch_scan as scan

    t_start = time.perf_counter()
    device = torch.device("cuda")
    env = phase_env()
    emit(env)
    log("build: compiling the kernel")
    emit(phase_build(scan))
    log("kernels: random programs")
    random_rows = check_random_programs(scan, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
        serve_line, mb, launches = phase_serve(port, store_mod, scan, store)
    kernels_line = phase_kernels(scan, mb, launches, random_rows)
    del mb
    torch.cuda.empty_cache()
    log("profile: measured provider on the card")
    profile_line = phase_profile(port)

    emit(kernels_line)
    emit(profile_line)
    serve_line["total_seconds"] = time.perf_counter() - t_start
    emit(serve_line)
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
