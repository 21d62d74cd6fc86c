#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths once, each at full width, each with its
kernels' launch counts set to 0 just before it and read just after:

* the serve path (gpt_145b: 80 layers, d_model 12288, d_ff 49152):
  ``DistSim.serve()`` answers the whole 1f1b+gpipe power-of-two strategy
  grid for 1024 devices (global batch 2048, seq 2048) as ONE mega-batch
  program scored by the hand-written Hopper scan kernel (K1, a dataflow
  scan over the program's walk layout), cold and then warm; then the
  grid's dp == 1 queries under a straggler (a program of its own, held
  bit-identical to numpy and, on four lanes, to the engine's perturbed
  run); then a second server over the warmed store (4 launches);
* the search path (the same model and fleet): ``SearchEngine`` over
  every power-of-two strategy of the 1024 devices, microbatches 16-128,
  1f1b, gpipe and interleaved, scored by K1 — cold, warm, then on numpy
  (2 launches), every entry identical across the three and the best
  eight equal to ``DistSim.simulate()``; and one degraded run of a
  full-width strategy (a straggler, then a fault with its checkpoint
  restore) on the host, held to the degraded matrix's invariants;
* the model path (h2o_danube_1_8b: 24 layers, d_model 2560, 32 heads
  over 8 KV heads, head_dim 80, window 4096; random bf16 weights from a
  seeded generator on the card): a B=2 x S=8192 prefill through
  ``make_prefill_step`` with ``attn_impl="cuda"`` (the flash-attention
  kernel K2, once a layer, on its bf16 tensor-core variant), decode
  through ``make_serve_step``, and the
  final norm's input through ``ops.rmsnorm`` (kernel K3, whose only
  entry is that public op: the reference's model never calls it);
* the model families, one at a time from a freed card, each with random
  bf16 weights from a seeded generator on the card: qwen3_moe_30b_a3b
  (MoE, 48 layers, 128 experts top-8; B=1 x S=4096 prefill, K2 once a
  layer at 8 query heads a KV head), mamba2_2_7b (SSM, 64 layers;
  B=2 x S=8192 chunked-SSD prefill, no kernel), jamba_v0_1_52b (hybrid,
  full width but cut to one 8-layer period: K2 once) and t5_large
  (encoder-decoder; B=2, 4096 encoder and 1024 decoder tokens: K2 36
  times, 12 of them cross-attention with Sq != Sk), each with a greedy
  decode and each prefill's layer-0 attention of every kind held
  against K2's plain version on the tensor cores; in fp32 at 2 layers
  (jamba at its 8, t5_large whole; an MoE at the dropless capacity)
  the kernel path against the plain path and decode == forward;
* the parallel layer, on a one-rank NCCL process group (a ``FileStore``
  in a temporary directory, no TCP port) and ``make_debug_mesh(1, 1)``:
  qwen3_moe_30b_a3b's bf16 prefill again on the families phase's
  weights with ``moe_impl="ep_a2a"`` over the one-rank ``model`` axis
  (K2 48 times on the tensor cores, 96 all-to-alls), and in fp32 at 2
  layers the ``ep_a2a`` logits against the ``gather`` logits at 1e-5
  (the config's capacity and the dropless one); ring attention at h2o's
  layer shape, bit-identical to ``flash_torch``; a full-width
  h2o_danube_1_8b train step with parameters and moments placed as
  DTensors by ``param_specs``/``zero1_specs`` through
  ``make_train_step(grad_specs=)``, against the plain step (loss rtol
  1e-5, gradient norm 1e-4); ``compressed_psum`` and ``ErrorFeedback``
  over that step's whole gradient tree, bit-identical to the int8
  round trip; and the launcher ``python -m repro_torch.launch.train``
  at full width in a child process;
* the training path (the same model): ``fit`` (see below), which
  launches none of the kernels, as the reference's training path calls
  no Pallas kernel.

Around that it

* builds the kernels from the sources in the checkout (``nvcc``,
  sm_90a, one process per source, all started together: K1, K2's
  tensor-core and scalar variants, K3), with ptxas's registers and
  spills per kernel;
* holds every kernel against its plain PyTorch version on the inputs the
  paths gave it (K1 bit-identical to its plain walk version and to the
  numpy reference; K2 within two bf16 ulps through its tensor-core
  variant, and on the same q, k, v upcast to fp32 at 2e-5 through its
  scalar variant; K3 within one bf16 ulp) and on seeded cases (K1 on
  random programs and chained ones with more chains a lane than it has
  walks; K2 and K3 also in fp32 at 2e-5 / 1e-5, TF32 off; K2's bf16
  cases asserted to take the tensor cores, a bf16 head_dim 40 case the
  scalar kernel; K3 on an unaligned view, d = 2561 and, in bf16, at
  every d_model of the configs), and times kernel, plain version and a
  PyTorch library call there (K3 also beside a same-bytes copy, with
  each variant's ptxas registers and spills, no spill allowed);
* checks the model's outputs by the repo's own means: prefill logits
  against the plain ``flash_torch`` attention path (in fp32 at 1e-4 x
  max |logit|; in bf16 the kernel path no further from the fp32 logits
  than 1.5 x the plain path), and fp32 decode against the fp32 forward
  at the reference's decode bar (2e-3);
* runs the static verifier (``repro_torch.analyze``) over the serve
  programs (clean and perturbed), the search program, every engine of
  the serve grid and both perturbations, gated on zero findings, and
  counts (ungated) the grid's strategies that do not fit the card's HBM;
* holds K2 on cross-attention (non-causal, Sq != Sk) against its plain
  version on seeded shapes and on t5_large's captured inputs, timed
  beside ``scaled_dot_product_attention``;
* profiles the unique events of one full-width pipeline stage with
  ``TorchMeasuredProvider`` on the card;
* trains: ``fit`` takes 6 AdamW steps of the same h2o_danube_1_8b at full
  width (bf16, no remat, B=2 x S=4096, ``attn_impl="auto"``, i.e. the
  plain ``flash_torch`` attention with its blockwise backward: the
  reference's training path calls no kernel, and K1-K3 are counted to
  stay at 0 there), gated on finite losses and gradient norms and a
  first loss within 1 of ln 32000; one step is profiled;
* closes the simulator's loop: the 1M1P1D prediction of that step by
  ``TorchMeasuredProvider`` (and, ungated, by the same provider with the
  reference's one-read epilogue and by ``HopperAnalyticalProvider``)
  against the measured step, the measured provider's ratio gated to
  (1/3, 3);
* holds the card to the CPU on one fp32 train step (TF32 off) of the
  model cut to 2 layers: loss at rtol 1e-5, gradient norm at 1e-4, each
  gradient leaf within 2e-5 x its max |g|;
* the dry run: the ring attention's backward on one NCCL rank against
  ``flash_torch``'s, the roofline held to the train phase's measured
  step, and each of ``DRYRUN_CELLS`` traced at full width on 256 or 512
  fake ranks in a child process, gated on its three roofline counts
  > 0 and, where ``DRYRUN_REFERENCE_FLOPS`` and ``DRYRUN_REFERENCE_COLL``
  have the reference's counts, on its collective bytes a device at most
  10 % over the reference's and its FLOPs within 10 % of them (decode)
  or at most 10 % over (where the port skips empty block pairs or the
  reference does work the port does not); those last cells' FLOPs are
  also held within 10 % of the port's own count as the CPU traces it
  (``DRYRUN_PORT_FLOPS``), so the card's torch cannot do more work
  under the one-sided bar.

Every phase prints one JSON object on a line of its own (``env``,
``build``, then ``kernels``, ``profile``, ``model``, ``serve``,
``search``, ``degraded``, ``analyze``, ``families``, ``parallel``,
``train``,
``loop_check``, ``train_check``, ``dryrun``);
then
the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``. Any failed check raises: the run exits non-zero and
prints no last line. There is no CPU mode — without a CUDA device the
script exits with code 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM datasheet peaks used for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 33.5e12          # vector fp64 (no tensor cores used)
BF16_FLOPS_PER_S = 989e12           # dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12            # fp32 outside the tensor cores

KERNELS = ("megabatch_scan", "flash_attention", "flash_attention_tc",
           "rmsnorm")

# K2 against its plain version. Both compute in fp32 and differ only in
# summation order, so a bf16 output may differ by a rounding step: two
# bf16 ulps (2^-6 relative) allow for it and stay far below the ~0.02
# typical |out| of a full 4096-key window, where losing one 64-key tile
# moves an output by ~0.003. In fp32 the reference's 2e-5.
K2_BF16_TOL = {"atol": 1e-5, "rtol": 2.0 ** -6}
K2_FP32_TOL = {"atol": 2e-5, "rtol": 2e-5}
# query rows and keys of one tile of K2's tensor-core variant (BM = BN in
# csrc/flash_attention_tc.cu), for the flops it issues
K2_TC_TILE = 128
# K3 against F.rms_norm (and a same-bytes copy): rounds of this many
# launches each, in turns
K3_ROUNDS, K3_REPS = 5, 200
# K3 against its plain version: both compute in fp32 and round once, so a
# reduction-order difference flips at most one bf16 rounding; fp32 1e-5
K3_BF16_ULPS = 1
K3_FP32_TOL = {"atol": 1e-5, "rtol": 1e-5}
# rows of each case of K3's width sweep (the main shape's 2 x 8192)
K3_SWEEP_ROWS = 16384
# profiler activity types that are work on the device
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")

ARCH = "gpt_145b"
N_DEVICES, GLOBAL_BATCH, SEQ = 1024, 2048, 2048
MAX_MP, MAX_PP = 64, 64             # <= 96 heads, <= 80 layers
CLUSTER = "h100-cluster"
# the serve path's perturbed batch: the grid's dp == 1 queries, device 0
# of the pipeline 1.5x slow (uniform across DP, as the program needs)
PERTURBED_RANK, PERTURBED_FACTOR = 0, 1.5
# the strategy search (the paper's §6 use-case) over the same model and
# fleet: every power-of-two (mp, pp, dp) of 1024 devices, these
# microbatch counts and schedules
SEARCH_MICROBATCHES = (16, 32, 64, 128)
SEARCH_SCHEDULES = ("1f1b", "gpipe", "interleaved")
SEARCH_CHECKED = 8                  # best entries held to simulate()
# the degraded run on the host: a fault at step 6 of 12, checkpoints
# every 4 steps, a straggler over the first 4 steps
DEGRADED_STRATEGY = dict(mp=8, pp=16, dp=8, microbatches=16)
DETECT_S, REPLAN_S = 10.0, 30.0     # heartbeat timeout; mesh re-plan

MODEL_ARCH = "h2o_danube_1_8b"
PREFILL_BATCH, PREFILL_SEQ = 2, 8192  # window 4096: active for half
PROMPT = 64                           # fp32 decode == forward check
DECODE_BATCH, DECODE_STEPS = 8, 256

# the training path: fit() of the same model, and the simulator's 1M1P1D
# prediction of that step held against it
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 6
TIMED_STEPS = slice(2, 6)             # the median step: steps 2-5
LOOP_BAR = (1 / 3, 3.0)               # the reference's own factor-3 bar
# the card against the CPU on one fp32 step of the model cut to 2 layers
CHECK_LAYERS, CHECK_BATCH, CHECK_SEQ = 2, 1, 2048
CHECK_LOSS_RTOL, CHECK_GNORM_RTOL, CHECK_GRAD_REL = 1e-5, 1e-4, 2e-5


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


def chained_program(seed: int, K: int, chains, length, device):
    """A random valid program shaped like a pipeline with more devices
    than the kernel has walks a lane: lane k has P chains of L rows (P
    drawn from ``chains``, past 64 so that chains fold onto walks), a
    chain's slots contiguous with dep0 the previous slot, row i of chain
    c at step i·P + c, dep1 a row of chain c-1 at or before row i and
    dep2 a row of chain c+1 before row i — dependencies between walks in
    both directions."""
    rng = np.random.default_rng(seed)
    P = rng.integers(chains[0], chains[1] + 1, size=K)
    L = rng.integers(length[0], length[1] + 1, size=K)
    lens = P * L
    T, total = int(lens.max()), int(lens.sum())
    out = np.full((T, K), total + 1, dtype=np.int32)
    dep = np.zeros((T, K, 3), dtype=np.int32)
    delay = np.zeros((T, K, 3))
    dur = np.zeros((T, K))
    base = 1
    for k in range(K):
        p, ln = int(P[k]), int(L[k])
        c, i = np.divmod(np.arange(p * ln), ln)
        slot = base + c * ln + i
        step = i * p + c
        out[step, k] = slot
        dep[step, k, 0] = np.where(i > 0, slot - 1, 0)
        fwd = np.maximum(i - rng.integers(0, 3, size=slot.size), 0)
        use = (c > 0) & (rng.random(slot.size) < 0.8)
        dep[step, k, 1] = np.where(use, base + (c - 1) * ln + fwd, 0)
        bwd = i - 1 - rng.integers(0, 3, size=slot.size)
        use = (c < p - 1) & (bwd >= 0) & (rng.random(slot.size) < 0.8)
        dep[step, k, 2] = np.where(use, base + (c + 1) * ln + bwd, 0)
        delay[step, k, 1:] = rng.random((slot.size, 2)) * 1e-3
        dur[step, k] = rng.random(slot.size) * 1e-2
        base += p * ln
    planes = [torch.from_numpy(a).to(device) for a in (out, dep, delay, dur)]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(device)
    return planes, total + 2, lengths


def host_walks(planes, n_slots, lengths):
    """The walk layout of a program given as planes, built on the host."""
    from repro_torch.kernels.megabatch_scan import build_walks
    out, dep, delay, dur = (t.cpu().numpy() for t in planes)
    return build_walks(out, [dep[..., d] for d in range(3)],
                       [delay[..., d] for d in range(3)], dur,
                       lengths.cpu().numpy(), n_slots)


def dag_depth(mb) -> int:
    """The longest dependency path of a compiled program, in rows:
    level = 1 + max(level of its dependencies) along each lane's steps,
    the dummy slot at level 0."""
    level = np.zeros(mb.n_slots, dtype=np.int64)
    d0, d1, d2, out = mb._dep0, mb._dep1, mb._dep2, mb._out
    for j in range(mb.T):
        # padding rows write the trash slot, which nothing reads
        level[out[j]] = 1 + np.maximum(np.maximum(level[d0[j]],
                                                  level[d1[j]]),
                                       level[d2[j]])
    return int(level[1: mb.total + 1].max())


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


def phase_build(wrappers) -> dict:
    """Compile all kernels at once (one nvcc each, in parallel), then
    bind each wrapper to its library."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load_kernels(KERNELS)
    for w in wrappers:
        w._library()
    seconds = time.perf_counter() - t0
    rows, dirs = [], set()
    for name in KERNELS:
        path, nvcc_seconds = build.BUILD_LOG[name]
        dirs.add(os.path.relpath(os.path.dirname(path), HERE))
        rows.append({"name": name,
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "nvcc_seconds": nvcc_seconds,
                     "library": os.path.basename(path),
                     "ptxas": ptxas_report(build.NVCC_OUTPUT.get(name, ""))})
    return {"phase": "build", "kernels": rows,
            "flags": list(build.NVCC_FLAGS), "seconds": seconds,
            "directory": sorted(dirs)}


def ptxas_report(text: str) -> list:
    """Registers and spill bytes per kernel from ``-Xptxas=-v``."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def check_random_programs(scan, device) -> list:
    """Kernel vs plain versions on seeded random programs: the walk
    kernel against the plain walk version on the same layout and
    against the plain step loop on the planes (ragged, and walking the
    padding); random programs fold most rows' chains onto shared walks,
    chained ones have more chains a lane than walks."""
    rows = []
    cases = [("random", (1, 1, 1)), ("random", (2, 33, 257)),
             ("random", (3, 444, 700)), ("random", (4, 1000, 64)),
             ("chained", (5, 7, (65, 200), (2, 40))),
             ("chained", (6, 132, (64, 130), (8, 64)))]
    for kind, args in cases:
        make = random_program if kind == "random" else chained_program
        planes, n_slots, lengths = make(*args, device)
        layout = host_walks(planes, n_slots, lengths)
        w = layout.to(device)
        ek, sk = scan.scan_walks(w, backend="cuda")
        torch.cuda.synchronize()
        ew, sw = scan.scan_walks(w, backend="torch")
        same = bool(torch.equal(ek, ew) and torch.equal(sk, sw))
        for ragged in (True, False):
            ep, sp = scan.scan_steps(*planes, n_slots,
                                     lengths=lengths if ragged else None)
            torch.cuda.synchronize()
            same = same and bool(torch.equal(ek, ep) and torch.equal(sk, sp))
        rows.append({"kind": kind, "seed": args[0], "K": args[1],
                     "T": int(planes[0].shape[0]),
                     "rows": int(layout.out.size),
                     "chains": layout.n_chains,
                     "walks": int(layout.walk_ptr.size - 1),
                     "walks_max": layout.max_walks,
                     "bit_identical": same})
        check(same, f"kernel != plain versions on {kind} program "
                    f"{args}")
        check(float(ek.max()) > 0.0, f"{kind} program evaluated to zeros")
    check(any(r["chains"] > r["walks"] and r["kind"] == "chained"
              and r["walks_max"] == 64 for r in rows),
          "no program had more chains a lane than the kernel has walks")
    return rows


def phase_serve(port, store_mod, scan, store_dir: str):
    """The main path: cold batch, warm batch, a perturbed batch (the
    grid's dp == 1 queries under one straggler: a program of its own),
    and a second server over the warmed store. Returns the JSON line,
    the compiled (clean) program and the launches the path made."""
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

    # the same server under a perturbation: engines and store entries
    # shared, the straggler plane compiled into a program of its own
    pert = port.Perturbation(stragglers=(
        port.Straggler(PERTURBED_RANK, PERTURBED_FACTOR),))
    dp1 = [i for i, s in enumerate(grid) if s.dp == 1]
    t0 = time.perf_counter()
    slow = server.answer_batch([dataclasses.replace(queries[i], perturb=pert)
                                for i in dp1])
    torch.cuda.synchronize()
    perturbed_s = time.perf_counter() - t0
    log(f"serve: perturbed batch of {len(dp1)} queries {perturbed_s:.3f}s")

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

    programs = {key[1]: prog for key, prog in server._programs.items()}
    check(set(programs) == {None, pert}, f"programs {list(programs)}")
    mb, mb_slow = programs[None], programs[pert]
    check(mb.K == len(queries) and mb.K >= 256, f"K = {mb.K} lanes")
    check(mb.T >= 16384, f"T = {mb.T} steps")
    check(mb.device.type == "cuda" and mb.resolve_backend("auto") == "cuda",
          "program is not on the card")
    check(launches == 4, f"serve path launched the kernel {launches}x, "
                         f"expected 4 (cold, warm, perturbed, second "
                         f"server)")

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

    # the perturbed batch: its program on numpy, the engine's own
    # perturbed run on the four smallest lanes, slower than clean
    bt_slow = np.asarray([a.batch_time for a in slow])
    check(mb_slow.K == len(dp1) and mb_slow.perturb == pert,
          f"perturbed program K = {mb_slow.K}")
    check(np.array_equal(bt_slow, mb_slow.predict("numpy").batch_times),
          "perturbed cuda batch times differ from the numpy backend")
    lanes = sorted(range(len(dp1)), key=lambda j: (
        grid[dp1[j]].pp * grid[dp1[j]].microbatches, j))[:4]
    for j in lanes:
        check(mb_slow.engines[j].run(perturb=pert).batch_time == bt_slow[j],
              f"perturbed answer {dp1[j]} differs from engine.run()")
    slowdown = bt_slow / bt_cold[dp1]
    check(bool(np.all(slowdown > 1.0)),
          "a perturbed answer is not slower than its clean one")

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
        "perturbed": {
            "perturbation": pert.label(), "queries": len(dp1),
            "selection": "the grid's dp == 1 queries",
            "K": mb_slow.K, "T": mb_slow.T,
            "live_steps": int(mb_slow._len.sum()),
            "seconds": perturbed_s, "bit_identical_to_numpy": True,
            "lanes_equal_to_engine_run": [
                f"{s.label()}@m{s.microbatches}:{s.schedule}"
                for s in (grid[dp1[j]] for j in lanes)],
            "slowdown_min": float(slowdown.min()),
            "slowdown_max": float(slowdown.max())},
        "feasible": int(sum(a.feasible for a in cold)),
        "best": {"strategy": grid[best].label(),
                 "microbatches": grid[best].microbatches,
                 "schedule": grid[best].schedule,
                 "batch_time": float(bt_cold[best])},
    }
    return line, mb, launches, (mb_slow, pert)


def port_config(name: str):
    from repro_torch.configs.base import get_config
    return get_config(name)


def k1_bound(mb):
    """(bytes, bound ms, what bounds it) of K1 on program ``mb``: every
    live step's row read once (out 4 + dep 12 + delay 24 + dur 8 bytes),
    lengths read once, ends and starts written once; 3 adds + 2 max + 1
    add per live step in fp64."""
    live = int(mb._len.sum())
    nbytes = live * 48 + mb.K * 4 + 2 * mb.n_slots * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = live * 6 / FP64_FLOPS_PER_S * 1e3
    return (nbytes, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def kernel_k1(scan, mb, launches: int, random_rows: list) -> dict:
    """K1 against its plain walk version and the numpy reference on the
    full-width program, with times and the bound computed from this
    run's inputs."""
    layout = mb.walk_layout()               # built on the serve path
    w = mb.device_walks()

    def kernel():
        return scan.scan_walks(w, backend="cuda")

    ek, sk = kernel()
    torch.cuda.synchronize()                # a fault would surface here
    ms = timed_ms(kernel, reps=5)
    log(f"kernels: kernel {ms:.3f} ms on the full-width program; "
        f"running the plain walk version ({mb.T} steps)")
    (ep, sp), plain_ms = event_ms(
        lambda: scan.scan_walks(w, backend="torch"))
    err = max(max_abs_diff(ek, ep), max_abs_diff(sk, sp))
    same = bool(torch.equal(ek, ep) and torch.equal(sk, sp))
    check(same and err == 0.0,
          f"kernel != plain walk version on the full-width program "
          f"(max abs err {err})")
    # against the host reference too, slot for slot
    ref_ends, ref_starts = mb._eval_numpy()
    check(np.array_equal(ek.cpu().numpy(), ref_ends)
          and np.array_equal(sk.cpu().numpy()[1: mb.total + 1],
                             ref_starts[1: mb.total + 1]),
          "kernel != numpy reference on the full-width program")
    depth = dag_depth(mb)
    live = int(mb._len.sum())
    nbytes, bound_ms, bound_by = k1_bound(mb)
    return {
        "name": "megabatch_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/megabatch_scan.cu",
        "replaces": "src/repro/kernels/megabatch_scan.py:91",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "design": "dataflow scan over walks: one block a lane, one "
                  "thread a walk, NaN sentinel in ends as ready flag",
        "plain": "scan_walks(backend='torch'): the walk layout in step "
                 "order",
        "dtype": "float64", "tolerance": "bit-identical (0.0)",
        "shape": {"T": mb.T, "K": mb.K, "n_slots": mb.n_slots,
                  "live_steps": live},
        "bound_bytes": nbytes, "chain_steps": mb.T,
        "ns_per_chain_step": ms * 1e6 / mb.T,
        "walks": int(layout.walk_ptr.size - 1),
        "walks_max": layout.max_walks, "chains": layout.n_chains,
        "threads_per_block": scan.threads_per_block(layout.max_walks),
        "dag_depth": depth, "ns_per_wave": ms * 1e6 / depth,
        "layout_seconds": layout.seconds,
        "layout_device_bytes": w.nbytes,
        "random_programs": random_rows,
    }


def search_entry(e) -> tuple:
    """Every field of a ``SearchEntry``, the strategy as a dict."""
    return tuple(dataclasses.asdict(e.strategy) if f.name == "strategy"
                 else getattr(e, f.name) for f in dataclasses.fields(e))


def phase_search(port, scan) -> dict:
    """The paper's §6 use-case at full width: ``SearchEngine`` over every
    power-of-two strategy of 1024 devices for gpt_145b on the H100
    cluster, scored as one mega-batch program by K1 — cold, then warm,
    then the same warm engine on the numpy backend."""
    from repro_torch.search import SearchEngine
    cfg = port_config(ARCH)
    grid = dict(microbatches=SEARCH_MICROBATCHES, schedules=SEARCH_SCHEDULES)
    log(f"search: {ARCH} on {N_DEVICES} devices, {grid}")
    scan.LAUNCHES = 0                       # just before the search path
    engine = SearchEngine(cfg, clusters=port.H100_CLUSTER,
                          megabatch_backend="cuda")
    seconds, results = {}, {}
    for run in ("cold", "warm", "numpy"):
        if run == "numpy":
            engine.megabatch_backend = "numpy"
        t0 = time.perf_counter()
        results[run] = engine.search(N_DEVICES, GLOBAL_BATCH, SEQ, **grid)
        torch.cuda.synchronize()
        seconds[run] = time.perf_counter() - t0
        log(f"search: {run} {seconds[run]:.3f}s")
    launches = scan.LAUNCHES                # just after the search path

    (mb,) = engine._megabatch_programs.values()
    cold, warm, host = results["cold"], results["warm"], results["numpy"]
    check(mb.K >= 256, f"K = {mb.K} lanes")
    check(mb.device.type == "cuda", "search program is not on the card")
    check(launches == 2, f"the search launched the kernel {launches}x, "
                         f"expected 2 (cold, warm; numpy none)")
    want = [search_entry(e) for e in cold.entries]
    for name, res in (("warm", warm), ("numpy", host)):
        check([search_entry(e) for e in res.entries] == want,
              f"{name} search entries differ from the cold search's")
        check([search_entry(e) for e in res.pareto]
              == [search_entry(e) for e in cold.pareto],
              f"{name} Pareto set differs")
    counters = ("candidates", "evaluated", "pruned_memory", "pruned_bound",
                "megabatch_lanes")
    stats = {k: getattr(cold.stats, k) for k in counters}
    for res in (warm, host):
        check({k: getattr(res.stats, k) for k in counters} == stats,
              "search stats differ between runs")
    check(warm.stats.provider_evaluations == 0, "warm search profiled")
    ranking = cold.ranking()
    check(len(ranking) >= SEARCH_CHECKED, f"{len(ranking)} ranked entries")
    for e in ranking[:SEARCH_CHECKED]:
        sim = port.DistSim(cfg, e.strategy, GLOBAL_BATCH, SEQ)
        check(sim.simulate().batch_time == e.batch_time,
              f"{e.strategy.label()} differs from DistSim.simulate()")

    # the engine reads K1's answer only on the lanes it evaluates (a lane
    # pruned by bound keeps its lower bound), so the entries above do not
    # show K1 right on every lane: hold its whole output, every lane and
    # slot, against the numpy reference (after the count was read)
    w = mb.device_walks()
    ek, sk = scan.scan_walks(w, backend="cuda")
    ref_ends, ref_starts = mb._eval_numpy()
    check(np.array_equal(ek.cpu().numpy(), ref_ends)
          and np.array_equal(sk.cpu().numpy()[1: mb.total + 1],
                             ref_starts[1: mb.total + 1]),
          "K1 != numpy reference on the search program")
    folded = int((mb._pp > scan.MAX_WALKS).sum())
    pp1024 = int((mb._pp == 1024).sum())
    log(f"search: K1 == numpy on all {mb.K} lanes ({folded} with folded "
        f"walks, pp > {scan.MAX_WALKS}; {pp1024} with pp = 1024)")
    kernel_ms = timed_ms(lambda: scan.scan_walks(w, backend="cuda"), reps=3)
    _, bound_ms, bound_by = k1_bound(mb)
    depth = dag_depth(mb)
    layout = mb.walk_layout()
    best = cold.best()
    return mb, {
        "phase": "search", "arch": ARCH, "devices": N_DEVICES,
        "global_batch": GLOBAL_BATCH, "seq": SEQ,
        "cluster": port.H100_CLUSTER.name,
        "microbatches": list(SEARCH_MICROBATCHES),
        "schedules": list(SEARCH_SCHEDULES), "backend": "cuda",
        "K": mb.K, "T": mb.T, "live_rows": int(mb._len.sum()),
        "dag_depth": depth, "walks": int(layout.walk_ptr.size - 1),
        "chains": layout.n_chains, "layout_seconds": layout.seconds,
        "device_bytes": mb.device_bytes(),
        "cold_seconds": seconds["cold"], "warm_seconds": seconds["warm"],
        "numpy_backend_seconds": seconds["numpy"],
        "k1_ms": kernel_ms, "k1_ns_per_wave": kernel_ms * 1e6 / depth,
        "k1_bound_ms": bound_ms,
        "k1_bound_by": bound_by, "kernel_launches": launches,
        "stats": {**stats,
                  "provider_evaluations": cold.stats.provider_evaluations},
        "identical_across_runs": True,
        "k1_equal_to_numpy_lanes": mb.K,
        "k1_equal_to_numpy_folded_lanes": folded,
        "k1_equal_to_numpy_pp1024_lanes": pp1024,
        "checked_against_simulate": SEARCH_CHECKED,
        "best": {"strategy": best.strategy.label(),
                 "microbatches": best.strategy.microbatches,
                 "schedule": best.strategy.schedule,
                 "batch_time": best.batch_time},
        "worst_feasible_batch_time": ranking[-1].batch_time,
        "pareto_size": len(cold.pareto)}


def phase_degraded(port) -> dict:
    """One degraded run of a full-width gpt_145b strategy on the H100
    cluster, on the host: ``DistSim.simulate(perturb=...)`` with a
    straggler and a fault, held to ``validate.degraded``'s structural
    invariants (segments tile the run, checkpoint arithmetic, a restore
    read that takes time, the grid only shrinks)."""
    from repro_torch.validate.degraded import DegradedCell, run_degraded_cell
    strat = port.Strategy(**DEGRADED_STRATEGY)
    world = strat.devices
    pert = port.Perturbation(
        stragglers=(port.Straggler(world // 2, 1.3, (0, 4)),),
        faults=(port.Fault(world - 1, 6, detect_s=DETECT_S),), steps=12,
        save_every=4, replan_s=REPLAN_S)
    cell = DegradedCell(ARCH, strat, pert, global_batch=GLOBAL_BATCH,
                        seq=SEQ)
    t0 = time.perf_counter()
    res = run_degraded_cell(cell, port.provider_for(port.H100_CLUSTER))
    seconds = time.perf_counter() - t0
    run = res.run
    check(res.violations == [], f"degraded invariants: {res.violations}")
    (rec,) = run.recoveries
    check(rec.restore_bytes > 0, "the restore read moved no byte")
    log(f"degraded: {cell.label()} {float(run.total_times[0]):.3f}s "
        f"over {pert.steps} steps")
    return (strat, pert), {
            "phase": "degraded", "arch": ARCH, "cluster": CLUSTER,
            "strategy": strat.label(), "perturbation": pert.label(),
            "global_batch": GLOBAL_BATCH, "seq": SEQ, "steps": pert.steps,
            "segments": [[sg.start, sg.stop] for sg in run.segments],
            "baseline_step_seconds": float(run.baseline_step_time[0]),
            "total_seconds": float(run.total_times[0]),
            "baseline_total_seconds": float(res.baseline_total[0]),
            "recovery": {e.kind: float(e.duration[0]) for e in rec.events},
            "restore_bytes": rec.restore_bytes,
            "final_strategy": run.final_strategy.label(),
            "effective_global_batch": run.effective_global_batch,
            "post_failure_step_seconds":
                float(run.post_failure_step_time[0]),
            "violations": res.violations, "seconds": seconds}


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




# --------------------------------------------------------------------------
# the model path
# --------------------------------------------------------------------------

@contextlib.contextmanager
def capture_inputs(ops, layers, final_norm):
    """While the model runs, keep the first ``ops.flash_attention`` call's
    arguments (layer 0's post-rope q, k, v) and the input of the final
    norm, so the kernels can be held against their plain versions on
    exactly what the path gave them. The calls themselves go through."""
    got = {}
    real_fa, real_norm = ops.flash_attention, layers.rmsnorm

    def fa_spy(q, k, v, q_pos=None, k_pos=None, **kw):
        got.setdefault("attention", (q, k, v, kw))
        return real_fa(q, k, v, q_pos, k_pos, **kw)

    def norm_spy(x, scale, *args, **kw):
        if scale is final_norm:
            got["final_norm_input"] = x
        return real_norm(x, scale, *args, **kw)

    ops.flash_attention, layers.rmsnorm = fa_spy, norm_spy
    try:
        yield got
    finally:
        ops.flash_attention, layers.rmsnorm = real_fa, real_norm


def event_ms(fn):
    """(result, milliseconds) of one call, timed with CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def phase_model(fa, rn):
    """h2o_danube_1_8b at full width: bf16 prefill through K2 (counted),
    checked against the plain attention path; the final norm through
    K3's public entry (counted); fp32 decode == fp32 forward; bf16
    greedy decode. Returns the JSON line, the captured kernel inputs
    and the launches each kernel made on its path."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train.step import make_prefill_step, make_serve_step

    cfg = port_config(MODEL_ARCH)
    dev = torch.device("cuda")
    opts = L.ModelOptions(dtype=torch.bfloat16, attn_impl="cuda")
    plain_opts = L.ModelOptions(dtype=torch.bfloat16, attn_impl="flash_torch")
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev,
                            opts)
    n_params = sum(t.numel() for t in _leaves(params))
    tok_gen = torch.Generator(dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_BATCH,
                                                    PREFILL_SEQ),
                                     generator=tok_gen, device=dev,
                                     dtype=torch.int32)}
    log(f"model: {MODEL_ARCH} full width, {n_params} parameters; prefill "
        f"B={PREFILL_BATCH} S={PREFILL_SEQ}")

    prefill = make_prefill_step(cfg, opts)
    with capture_inputs(ops, L, params["final_norm"]) as captured:
        fa.LAUNCHES = fa.TC_LAUNCHES = 0    # just before the prefill
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        k2_launches = fa.LAUNCHES           # just after
        k2_tc_launches = fa.TC_LAUNCHES
    check(k2_launches == cfg.n_layers,
          f"prefill launched K2 {k2_launches}x, expected {cfg.n_layers}")
    check(k2_tc_launches == cfg.n_layers,
          f"prefill launched K2's tensor-core variant {k2_tc_launches}x, "
          f"expected {cfg.n_layers}")
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab),
          f"prefill logits of shape {tuple(logits.shape)}")
    last = logits[:, -128:].float()
    check(bool(torch.isfinite(last).all()), "prefill logits not finite")
    del logits
    prefill_ms = [event_ms(lambda: prefill(params, batch))[1]
                  for _ in range(3)]
    median_ms = sorted(prefill_ms)[1]

    plain_logits, plain_ms = event_ms(
        lambda: make_prefill_step(cfg, plain_opts)(params, batch))
    plain_last = plain_logits[:, -128:].float()
    del plain_logits
    log(f"model: prefill {median_ms:.1f} ms (flash_torch {plain_ms:.1f} ms)")

    # K3's path: its public entry on the final norm's input
    x = captured["final_norm_input"]
    rn.LAUNCHES = 0                         # just before
    normed = ops.rmsnorm(x, params["final_norm"])
    torch.cuda.synchronize()
    k3_launches = rn.LAUNCHES               # just after
    check(k3_launches == 1, f"ops.rmsnorm launched K3 {k3_launches}x")
    norm_err = max_abs_diff(normed.float(),
                            L.rmsnorm(x, params["final_norm"]).float())
    check(torch.allclose(normed.float(),
                         L.rmsnorm(x, params["final_norm"]).float(),
                         atol=2e-2, rtol=2e-2),
          f"ops.rmsnorm != layers.rmsnorm (max abs err {norm_err})")

    # the same weights in fp32 (the bf16 ones are their rounding)
    opts32 = L.ModelOptions(dtype=torch.float32, attn_impl="cuda")
    params32 = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev,
                              opts32)
    logits_check = check_prefill_logits(cfg, params32, batch, last,
                                        plain_last)
    decode_check = check_decode_fp32(cfg, params32, dev)
    del params32
    torch.cuda.empty_cache()

    log(f"model: bf16 greedy decode, B={DECODE_BATCH}, {DECODE_STEPS} steps")
    step = make_serve_step(cfg, opts)
    cache = lm.init_cache(cfg, DECODE_BATCH, PREFILL_SEQ, opts, dev)
    tok = torch.randint(0, cfg.vocab, (DECODE_BATCH, 1), generator=tok_gen,
                        device=dev, dtype=torch.int32)
    out, cache = step(params, cache, {"tokens": tok})   # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        tok = out.argmax(dim=-1, keepdim=True).to(torch.int32)
        out, cache = step(params, cache, {"tokens": tok})
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(bool(torch.isfinite(out).all()), "decode logits not finite")
    check(cache["pos"].tolist() == [DECODE_STEPS + 1] * DECODE_BATCH,
          "decode positions did not advance")
    decode_profile = device_breakdown(lambda: [
        step(params, cache, {"tokens": tok}) for _ in range(4)])
    prefill_profile = device_breakdown(lambda: prefill(params, batch))

    line = {
        "phase": "model", "arch": MODEL_ARCH, "parameters": n_params,
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "window": cfg.sliding_window,
        "dtype": "bfloat16", "weights": "random, torch.Generator seed 0",
        "prefill": {
            "batch": PREFILL_BATCH, "seq": PREFILL_SEQ, "attn_impl": "cuda",
            "k2_launches": k2_launches, "k2_tc_launches": k2_tc_launches,
            "ms_median": median_ms,
            "ms": prefill_ms,
            "tokens_per_s": PREFILL_BATCH * PREFILL_SEQ / median_ms * 1e3,
            "flash_torch_ms": plain_ms},
        "logits_check": logits_check,
        "rmsnorm_entry": {"k3_launches": k3_launches,
                          "max_abs_err_vs_layers_rmsnorm": norm_err},
        "decode_check": decode_check,
        "decode": {"batch": DECODE_BATCH, "steps": DECODE_STEPS,
                   "seconds": decode_s,
                   "tokens_per_s": DECODE_BATCH * DECODE_STEPS / decode_s,
                   "ms_per_step": decode_s / DECODE_STEPS * 1e3,
                   "cache_slots": int(cache["attn"]["k"].shape[2]),
                   "profile_4_steps": decode_profile},
        "prefill_profile": prefill_profile,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    captured["final_norm"] = params["final_norm"]
    launches = {"flash_attention": k2_launches,
                "flash_attention_tc": k2_tc_launches, "rmsnorm": k3_launches}
    return line, captured, launches


def is_device_work(e) -> bool:
    """A kernel, copy or memset on the card's timeline. The profiler's
    device rows also hold user annotations that span their kernels
    (``aten::mm``) and overhead records (``Command Buffer Full``):
    counted with the kernels they put the busy share above 1."""
    from torch.autograd import DeviceType
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in DEVICE_WORK
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("aten::")
            and e.name != "Command Buffer Full")


def device_breakdown(fn, top: int = 8, spans=()) -> dict:
    """``torch.profiler`` over one call of ``fn``: the device's busy time
    (the union of the intervals of its kernels, copies and memsets),
    that time's share of the wall time, the ``top`` kernels by device
    time, the ``top`` operators by the device time of the kernels they
    launched themselves and, for each ``record_function`` range named in
    ``spans``, the device time of the kernels launched inside it. Fails
    if the share exceeds 1."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    work = [e for e in prof.events() if is_device_work(e)]
    check(bool(work), "the profiler saw no work on the device")
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in work):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in work:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device_us = sum(us for _, us in by_name.values())
    share = busy_us / wall_us
    check(share <= 1.0, f"device busy {busy_us} us of {wall_us} us wall")
    rows = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    span_us = {}
    for e in prof.events():     # the CPU ranges; their GPU annotations
        if e.name in spans and e.device_type == DeviceType.CPU:
            n, us = span_us.get(e.name, (0, 0.0))
            span_us[e.name] = (n + 1, us + e.device_time_total)
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.key not in spans
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "spans": {k: {"count": n, "device_us": us}
                      for k, (n, us) in sorted(span_us.items())},
            "top_ops": [{"op": e.key[:80], "count": e.count,
                         "device_us": e.self_device_time_total}
                        for e in ops[:top]],
            "device_busy_share": share, "device_us": device_us,
            "kernel_launches": len(work),
            "counted": "activity_type" if getattr(
                work[0], "activity_type", None) is not None else "names",
            "top": [{"kernel": name[:120], "count": n, "device_us": us,
                     "share": us / device_us}
                    for name, (n, us) in rows[:top]]}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def check_prefill_logits(cfg, params32, batch, last_bf16, plain_bf16):
    """The prefill's last 128 positions, kernel path against the plain
    ``flash_torch`` path. In fp32 the two are held to 1e-4 x max |logit|.
    In bf16 both carry the whole model's bf16 rounding, which over 24
    full-width layers alone differs between the two plain paths by
    about that much; so there the kernel path's distance from the fp32
    logits is held to at most 1.5 x the plain path's distance."""
    from repro_torch.models import layers as L
    from repro_torch.train.step import make_prefill_step
    log("model: fp32 prefill, kernel path and flash_torch path")
    out = {}
    for impl in ("cuda", "flash_torch"):
        opts = L.ModelOptions(dtype=torch.float32, attn_impl=impl)
        logits = make_prefill_step(cfg, opts)(params32, batch)
        out[impl] = logits[:, -128:].clone()
        del logits
    ref = out["flash_torch"]
    top = float(ref.abs().max())
    fp32_diff = max_abs_diff(out["cuda"], ref)
    check(bool(torch.isfinite(out["cuda"]).all()),
          "fp32 prefill logits not finite")
    check(fp32_diff <= 1e-4 * top,
          f"fp32 prefill logits differ from the flash_torch path by "
          f"{fp32_diff} (max |logit| {top})")
    kernel_err = max_abs_diff(last_bf16, ref)
    plain_err = max_abs_diff(plain_bf16, ref)
    check(kernel_err <= 1.5 * plain_err,
          f"bf16 kernel path is {kernel_err} from the fp32 logits, the "
          f"plain path {plain_err}")
    return {"positions": "last 128", "max_abs_logit_fp32": top,
            "fp32_kernel_vs_flash_torch": fp32_diff,
            "fp32_tolerance": "1e-4 x max |logit|",
            "bf16_kernel_vs_flash_torch": max_abs_diff(last_bf16,
                                                       plain_bf16),
            "bf16_kernel_path_vs_fp32": kernel_err,
            "bf16_flash_torch_path_vs_fp32": plain_err,
            "bf16_tolerance": "kernel path within 1.5 x the plain path's "
                              "distance from fp32"}


def check_decode_fp32(cfg, params, dev) -> dict:
    """fp32 weights, B=2: a PROMPT-token prompt fed one token at a time
    from ``init_cache(2, 8192)`` against the fp32 prefill (through the
    fp32 K2), step by step at the reference's bar."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train.step import make_prefill_step, make_serve_step
    log(f"model: fp32 decode == forward over {PROMPT} tokens")
    opts = L.ModelOptions(dtype=torch.float32, attn_impl="cuda")
    prompt = torch.randint(0, cfg.vocab, (2, PROMPT), device=dev,
                           generator=torch.Generator(dev).manual_seed(2),
                           dtype=torch.int32)
    full = make_prefill_step(cfg, opts)(params, {"tokens": prompt})
    step = make_serve_step(cfg, opts)
    cache = lm.init_cache(cfg, 2, PREFILL_SEQ, opts, dev)
    worst = 0.0
    for i in range(PROMPT):
        logits, cache = step(params, cache, {"tokens": prompt[:, i:i + 1]})
        want = full[:, i]
        worst = max(worst, max_abs_diff(logits, want))
        check(bool(torch.isfinite(logits).all()) and torch.allclose(
            logits, want, atol=2e-3, rtol=2e-3),
            f"fp32 decode step {i} != forward (max abs diff {worst})")
    return {"dtype": "float32", "batch": 2, "prompt": PROMPT,
            "max_abs_diff": worst, "max_abs_logit": float(full.abs().max()),
            "tolerance": "atol = rtol = 2e-3"}


# --------------------------------------------------------------------------
# K2 and K3 against their plain versions
# --------------------------------------------------------------------------

def band_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Valid (q, k) pairs of one (batch, head) under the masks."""
    q = np.arange(sq)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def seeded_qkv(shape, dtype, seed=0):
    b, s, h, kh, hd = shape
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(dims, generator=g, device="cuda").to(dtype)
            for dims in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]


def k2_tc_flops(b: int, h: int, s: int, hd: int, causal: bool,
                window) -> int:
    """Flops K2's tensor-core variant issues: every (128-row q tile, 128-key
    kv tile) it visits costs Q K^T plus P_hi V and P_lo V, 6 x 128 x 128 x
    hd, masked parts included."""
    t, tiles = K2_TC_TILE, 0
    for q0 in range(0, s, t):
        q_last = min(q0 + t, s) - 1
        kv_lo = max(0, q0 - window + 1) if window else 0
        kv_hi = q_last + 1 if causal else s
        tiles += -(-kv_hi // t) - kv_lo // t
    return b * h * tiles * 6 * t * t * hd


def check_k2_case(fa, q, k, v, causal, window, tc: bool) -> float:
    """One K2 call against its plain version at the bar of its dtype,
    asserting which variant ran; returns the max abs error."""
    check(fa.uses_tensor_cores(q, k, v) is tc,
          f"dispatch rule: tensor cores {not tc} for {tuple(q.shape)} "
          f"{q.dtype} strides {q.stride()}")
    tc_before = fa.TC_LAUNCHES
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(fa.TC_LAUNCHES == tc_before + int(tc),
          f"{'no' if tc else 'a'} tensor-core launch for {tuple(q.shape)} "
          f"{q.dtype}")
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = K2_BF16_TOL if q.dtype == torch.bfloat16 else K2_FP32_TOL
    e = max_abs_diff(got.float(), want.float())
    check(torch.allclose(got.float(), want.float(), **tol),
          f"K2 != plain version on {tuple(q.shape)} {tuple(k.shape)} "
          f"causal={causal} window={window} {q.dtype} (max abs err {e})")
    return e


def kernel_k2(fa, captured, launches: int, tc_launches: int) -> dict:
    q, k, v, kw = captured["attention"]
    causal, window = kw["causal"], kw["window"]
    check(fa.uses_tensor_cores(q, k, v),
          "the model's bf16 layer does not take the tensor cores")

    def kernel():
        return fa.flash_attention_cuda(q, k, v, causal=causal, window=window)

    tc_before = fa.TC_LAUNCHES
    out = kernel()
    torch.cuda.synchronize()
    check(fa.TC_LAUNCHES == tc_before + 1, "K2 bf16 missed the tensor cores")
    ms = timed_ms(kernel, reps=10)
    log(f"kernels: K2 {ms:.3f} ms on layer 0's q, k, v; plain version")
    plain, plain_ms = event_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal, window=window))
    err = max_abs_diff(out.float(), plain.float())
    check(torch.allclose(out.float(), plain.float(), **K2_BF16_TOL),
          f"K2 != plain version on the model's layer (max abs err {err})")
    mean_abs_out = float(plain.float().abs().mean())
    del plain
    # the same q, k, v in fp32 go to the scalar kernel, IEEE fp32 inside,
    # so here only summation order separates it from the plain version
    q32, k32, v32 = (t.float() for t in (q, k, v))
    check(not fa.uses_tensor_cores(q32, k32, v32), "fp32 took the tensor "
                                                   "cores")

    def kernel32():
        return fa.flash_attention_cuda(q32, k32, v32, causal=causal,
                                       window=window)

    got32 = kernel32()
    torch.cuda.synchronize()
    fp32_ms = timed_ms(kernel32, reps=2)
    want32 = fa.flash_attention_plain(q32, k32, v32, causal=causal,
                                      window=window)
    err32 = max_abs_diff(got32, want32)
    check(torch.allclose(got32, want32, **K2_FP32_TOL),
          f"K2 != plain version on the model's layer in fp32 (max abs err "
          f"{err32})")
    del q32, k32, v32, got32, want32

    b, s, h, hd = q.shape
    i = torch.arange(s, device="cuda")
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True)

    lib_out = library()
    torch.cuda.synchronize()
    library_ms = timed_ms(library, reps=3)
    library_err = max_abs_diff(lib_out.transpose(1, 2).float(), out.float())
    del lib_out, band
    check(ms <= library_ms, f"K2 took {ms} ms, the library call "
                            f"{library_ms} ms")

    cases = []
    shapes = [((1, 128, 4, 4, 64), c, None) for c in (True, False)] \
        + [((2, 256, 4, 2, 64), c, None) for c in (True, False)] \
        + [((1, 200, 8, 2, 32), c, None) for c in (True, False)] \
        + [((2, 64, 2, 1, 128), c, None) for c in (True, False)] \
        + [((1, 300, 16, 2, 64), c, None) for c in (True, False)] \
        + [((1, 160, 4, 2, 32), True, w) for w in (16, 64, 1000)] \
        + [((1, 300, 8, 2, 80), True, 64), ((1, 150, 8, 2, 80), False, 40)]
    for shape, c, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            sq, sk, sv = seeded_qkv(shape, dtype)
            tc = dtype == torch.bfloat16
            e = check_k2_case(fa, sq, sk, sv, c, w, tc)
            cases.append({"shape": list(shape), "causal": c, "window": w,
                          "dtype": str(dtype).split(".")[-1],
                          "variant": "tensor_cores" if tc else "scalar",
                          "max_abs_err": e,
                          "tolerance": K2_BF16_TOL if tc else K2_FP32_TOL})
    # q, k, v as aligned strided views of one fused (B, S, (H+2KH)·hd)
    # projection: the tensor cores read them in place
    fb, fs, fh, fkh, fhd = 2, 640, 8, 2, 80
    fused = torch.randn((fb, fs, (fh + 2 * fkh) * fhd), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5)
                        ).to(torch.bfloat16)
    fq = fused[..., :fh * fhd].unflatten(-1, (fh, fhd))
    fk = fused[..., fh * fhd:(fh + fkh) * fhd].unflatten(-1, (fkh, fhd))
    fv = fused[..., (fh + fkh) * fhd:].unflatten(-1, (fkh, fhd))
    e = check_k2_case(fa, fq, fk, fv, True, 200, True)
    cases.append({"shape": [fb, fs, fh, fkh, fhd], "causal": True,
                  "window": 200, "dtype": "bfloat16",
                  "layout": "strided views of one fused qkv buffer",
                  "variant": "tensor_cores", "max_abs_err": e,
                  "tolerance": K2_BF16_TOL})
    # a bf16 head_dim the tensor-core variant does not take
    sq, sk, sv = seeded_qkv((1, 300, 8, 2, 40), torch.bfloat16)
    e = check_k2_case(fa, sq, sk, sv, True, 64, False)
    cases.append({"shape": [1, 300, 8, 2, 40], "causal": True, "window": 64,
                  "dtype": "bfloat16", "variant": "scalar",
                  "max_abs_err": e, "tolerance": K2_BF16_TOL})

    pairs = band_pairs(s, k.shape[1], causal, window) * b * h
    flops = 4 * hd * pairs
    issued = k2_tc_flops(b, h, s, hd, causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:74",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "attn_mask=band, enable_gqa=True)",
        "library_max_abs_err": library_err,
        "variant": "tensor_cores: TMA + wgmma bf16, P·V as P_hi·V + P_lo·V",
        "tc_launches": tc_launches,
        "smem_bytes_per_block": fa._library()["tc"]
        .flash_attention_tc_smem_bytes(hd),
        "dtype": "bfloat16", "tolerance": K2_BF16_TOL,
        "mean_abs_out": mean_abs_out,
        "fp32_ms": fp32_ms,
        "fp32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "fp32_max_abs_err": err32, "fp32_tolerance": K2_FP32_TOL,
        "shape": {"q": list(q.shape), "k": list(k.shape), "causal": causal,
                  "window": window},
        "band_pairs": pairs, "bound_flops": flops, "bound_bytes": nbytes,
        "issued_flops": issued,
        "achieved_tflops": flops / ms / 1e9,
        "kernel_tflops": issued / ms / 1e9,
        "fp32_cuda_core_bound_ms": flops / FP32_FLOPS_PER_S * 1e3,
        "cases": cases,
    }


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bf16 tensors in units in the last
    place, counted on their ``uint16`` patterns (sign-magnitude mapped to
    a line, so +0 and -0 coincide and a step across 0 counts its ulps)."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    if not a.numel():
        return 0
    return int((line(a) - line(b)).abs().max().item())


def k3_held(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """K3's bar against its plain version: both compute in fp32 and round
    once, so a reduction-order difference can flip at most one bf16
    rounding (≤ 1 ulp, on the uint16 views); fp32 at 1e-5."""
    err = max_abs_diff(got.float(), want.float())
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        check(ulps <= K3_BF16_ULPS, f"K3 != plain version on {what}: "
              f"{ulps} bf16 ulps (max abs err {err})")
        return {"max_abs_err": err, "max_ulps": ulps}
    check(torch.allclose(got, want, **K3_FP32_TOL),
          f"K3 != plain version on {what} (max abs err {err})")
    return {"max_abs_err": err, "max_ulps": None}


def k3_turns(fns: dict) -> dict:
    """The functions of ``fns`` timed in turns on the same inputs,
    ``K3_ROUNDS`` rounds of ``K3_REPS`` launches each, the order reversed
    every other round (ABC, CBA, ...), so the card's drift within the
    call falls on all of them: per name the rounds' ms, their median and
    their spread."""
    rounds = {name: [] for name in fns}
    order = list(fns.items())
    for r in range(K3_ROUNDS):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            rounds[name].append(timed_ms(fn, reps=K3_REPS))
    return {name: {"ms": v, "median_ms": float(np.median(v)),
                   "spread_ms": float(max(v) - min(v))}
            for name, v in rounds.items()}


def k3_verdict(turns: dict) -> str:
    """K3 against ``F.rms_norm``: ``ahead`` or ``behind`` where the medians
    differ by more than the larger of the two spreads, else ``level``."""
    k3, lib = turns["k3"], turns["library"]
    spread = max(k3["spread_ms"], lib["spread_ms"])
    if lib["median_ms"] - k3["median_ms"] > spread:
        return "ahead"
    return "behind" if k3["median_ms"] - lib["median_ms"] > spread \
        else "level"


def k3_bytes(x: torch.Tensor, scale: torch.Tensor) -> int:
    """What K3 must move: x read once, out written once, the scale read
    once."""
    return 2 * x.numel() * x.element_size() \
        + scale.numel() * scale.element_size()


def device_and_host(fn, reps: int) -> dict:
    """Whether a run of ``reps`` back-to-back calls measures the device:
    ``torch.profiler`` over one such run gives each kernel's device
    duration (median per name) and the device µs a call; the host µs a
    call is the wall clock over issuing ``reps`` calls without a
    synchronise. A call is device-bound where its host µs are below its
    device µs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    work = [e for e in prof.events() if is_device_work(e)]
    check(bool(work), "the profiler saw no work on the device")
    by_name: dict = {}
    for e in work:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device_us = sum(sum(v) for v in by_name.values()) / reps
    return {"host_us_per_call": host_us, "device_us_per_call": device_us,
            "device_bound": host_us < device_us,
            "kernels": [{"kernel": name[:120], "launches": len(v),
                         "median_us": float(np.median(v))}
                        for name, v in sorted(by_name.items())]}


def k3_ptxas(text: str) -> list:
    """ptxas's registers and spills for each of K3's kernels, named by
    variant, x dtype and vectors a thread (register variant) or scale
    dtype (general variant)."""
    names = {"f": "float32", "13__nv_bfloat16": "bfloat16",
             "6__half": "float16"}
    rows = []
    for r in ptxas_report(text):
        fn = r["function"]
        m = re.search(r"rmsnorm_rowsI(f|13__nv_bfloat16)Li(\d+)E", fn)
        # a repeated type is mangled as a back-reference (S1_, S2_, ...)
        g = re.search(r"rmsnorm_generalI(f|13__nv_bfloat16)"
                      r"(f|13__nv_bfloat16|6__half|S\d*_)E", fn)
        if m:
            label = {"variant": "rows", "x": names[m.group(1)],
                     "vpt": int(m.group(2))}
        elif g:
            x = names[g.group(1)]
            label = {"variant": "general", "x": x,
                     "scale": names.get(g.group(2), x)}
        else:
            label = {"variant": "unknown", "function": fn[:120]}
        rows.append({**label, "registers": r.get("registers"),
                     "spill_stores": r.get("spill_stores", 0),
                     "spill_loads": r.get("spill_loads", 0)})
    return rows


def config_widths() -> list:
    """Every distinct d_model of the port's configs."""
    from repro_torch.configs.base import get_config, list_archs
    return sorted({get_config(a).d_model for a in list_archs()})


def kernel_k3(rn, captured, launches: int) -> dict:
    from repro_torch.kernels import build, ops
    x, final_norm = captured["final_norm_input"], captured["final_norm"]
    x2 = x.reshape(-1, x.shape[-1])
    d = x2.shape[-1]
    check(rn.plan(d, x2.dtype, final_norm.dtype).variant == "rows",
          f"the main shape {tuple(x2.shape)} did not plan the register "
          f"variant")
    ptxas = k3_ptxas(build.NVCC_OUTPUT.get("rmsnorm", ""))
    spilled = [r for r in ptxas if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"K3 variants spill: {spilled}")

    def kernel():
        return rn.rmsnorm_cuda(x2, final_norm)

    out = kernel()
    torch.cuda.synchronize()
    plain = rn.rmsnorm_plain(x2, final_norm)
    plain_ms = timed_ms(lambda: rn.rmsnorm_plain(x2, final_norm), reps=5)
    main_bar = k3_held(out, plain, f"the final norm's input {tuple(x2.shape)}")
    err, worst_ulps = main_bar["max_abs_err"], main_bar["max_ulps"] or 0
    del plain

    def library():
        return torch.nn.functional.rms_norm(x2, (d,), final_norm, eps=1e-6)

    copy_out = torch.empty_like(x2)

    def copy():
        return copy_out.copy_(x2)

    library()
    copy()
    turns = k3_turns({"k3": kernel, "library": library, "copy": copy})
    ms, library_ms = turns["k3"]["median_ms"], turns["library"]["median_ms"]
    copy_ms = turns["copy"]["median_ms"]
    verdict = k3_verdict(turns)
    log(f"kernels: K3 {ms:.5f} ms, F.rms_norm {library_ms:.5f} ms, copy "
        f"{copy_ms:.5f} ms (medians of {K3_ROUNDS} x {K3_REPS}): {verdict}")
    evidence = {"k3": device_and_host(kernel, K3_REPS),
                "library": device_and_host(library, K3_REPS),
                "copy": device_and_host(copy, K3_REPS)}
    del copy_out

    # every config width, bf16 x and scale, at the main shape's rows
    sweep = []
    g = torch.Generator("cuda").manual_seed(17)
    for w in config_widths():
        xs = torch.randn((K3_SWEEP_ROWS, w), generator=g,
                         device="cuda").to(torch.bfloat16)
        sc = torch.randn((w,), generator=g, device="cuda").to(torch.bfloat16)
        p = rn.plan(w, xs.dtype, sc.dtype)
        bar = k3_held(rn.rmsnorm_cuda(xs, sc), rn.rmsnorm_plain(xs, sc),
                      f"the sweep's ({K3_SWEEP_ROWS}, {w}) bf16")
        worst_ulps = max(worst_ulps, bar["max_ulps"])
        co = torch.empty_like(xs)
        t = k3_turns({
            "k3": lambda: rn.rmsnorm_cuda(xs, sc),
            "library": lambda: torch.nn.functional.rms_norm(
                xs, (w,), sc, eps=1e-6),
            "copy": lambda: co.copy_(xs)})
        nb = k3_bytes(xs, sc)
        sweep.append({
            "d": w, "plan": p._asdict(), **bar,
            "k3_median_ms": t["k3"]["median_ms"],
            "library_median_ms": t["library"]["median_ms"],
            "copy_median_ms": t["copy"]["median_ms"],
            "k3_spread_ms": t["k3"]["spread_ms"],
            "library_spread_ms": t["library"]["spread_ms"],
            "verdict": k3_verdict(t),
            "bound_ms": nb / HBM_BYTES_PER_S * 1e3,
            "achieved_tb_per_s": nb / t["k3"]["median_ms"] / 1e9,
            "library_tb_per_s": nb / t["library"]["median_ms"] / 1e9})
        log(f"kernels: K3 sweep d={w}: {sweep[-1]['k3_median_ms']:.5f} / "
            f"{sweep[-1]['library_median_ms']:.5f} ms, {sweep[-1]['verdict']}")
        del xs, co

    # seeded odd cases: the reference's test shapes, an unaligned view
    # (contiguous, one element past a 16-byte boundary) and d = 2561
    cases = []
    for i, shape in enumerate(((8, 128), (3, 100, 96), (2, 5, 7, 256),
                               (1, 512), "unaligned", (7, 2561))):
        for dtype in (torch.float32, torch.bfloat16):
            gi = torch.Generator("cuda").manual_seed(i)
            if shape == "unaligned":
                buf = torch.randn(37 * 2560 + 1, generator=gi,
                                  device="cuda").to(dtype)
                xs = buf[1:].view(37, 2560)
            else:
                xs = torch.randn(shape, generator=gi, device="cuda").to(dtype)
            sc = torch.randn(xs.shape[-1:], generator=gi, device="cuda")
            p = rn.plan(xs.shape[-1], dtype, sc.dtype,
                        xs.data_ptr() % 16 == 0)
            got = ops.rmsnorm(xs, sc)
            torch.cuda.synchronize()
            bar = k3_held(got, rn.rmsnorm_plain(xs, sc),
                          f"{shape} {dtype}")
            worst_ulps = max(worst_ulps, bar["max_ulps"] or 0)
            cases.append({"shape": list(xs.shape) if shape != "unaligned"
                          else ["unaligned", *xs.shape],
                          "dtype": str(dtype).split(".")[-1],
                          "variant": p.variant, **bar})

    nbytes = k3_bytes(x2, final_norm)
    flops = 4 * x2.numel()                  # square-add, two scalings
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library": "torch.nn.functional.rms_norm",
        "copy_ms": copy_ms,
        "plan": rn.plan(d, x2.dtype, final_norm.dtype)._asdict(),
        "paired": {"rounds": K3_ROUNDS, "reps": K3_REPS,
                   "order": "ABC, CBA (K3, F.rms_norm, copy)",
                   "k3_ms": turns["k3"]["ms"],
                   "library_ms": turns["library"]["ms"],
                   "copy_ms": turns["copy"]["ms"],
                   "k3_median_ms": ms, "library_median_ms": library_ms,
                   "copy_median_ms": copy_ms,
                   "k3_spread_ms": turns["k3"]["spread_ms"],
                   "library_spread_ms": turns["library"]["spread_ms"],
                   "copy_spread_ms": turns["copy"]["spread_ms"],
                   "verdict": verdict},
        "device_vs_host": evidence,
        "sweep": sweep,
        "ptxas": ptxas,
        "dtype": "bfloat16",
        "tolerance": f"bf16: at most {K3_BF16_ULPS} ulp (uint16 views); "
                     f"fp32: atol = rtol = {K3_FP32_TOL['atol']}",
        "max_ulps_seen": worst_ulps,
        "shape": {"x": list(x2.shape), "scale_dtype":
                  str(final_norm.dtype).split(".")[-1]},
        "bound_bytes": nbytes,
        "achieved_tb_per_s": nbytes / ms / 1e9,
        "copy_tb_per_s": nbytes / copy_ms / 1e9,
        "cases": cases,
    }


# --------------------------------------------------------------------------
# the training path and the simulator's loop
# --------------------------------------------------------------------------

#: ``record_function`` ranges put around these functions while a train
#: step is profiled: (module, function, range name)
TRAIN_SPANS = (("repro_torch.models.lm", "loss_fn", "forward+loss"),
               ("repro_torch.models.lm", "_chunked_ce", "cross_entropy"),
               ("repro_torch.models.layers", "_flash_fwd_impl",
                "flash_torch_fwd"),
               ("repro_torch.models.layers", "_flash_bwd_impl",
                "flash_torch_bwd"),
               ("repro_torch.train.optimizer", "update", "adamw"))


@contextlib.contextmanager
def named_spans(targets):
    """While the block runs, each (module, function) of ``targets`` runs
    inside a ``torch.profiler.record_function`` range of its name; the
    calls themselves go through."""
    import importlib
    saved = []
    for module, attr, label in targets:
        mod = importlib.import_module(module)
        real = getattr(mod, attr)

        def wrapped(*args, _real=real, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _real(*args, **kw)

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, real))
    try:
        yield
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def reset_launches(counters) -> None:
    for mod in counters:
        mod.LAUNCHES = 0
        if hasattr(mod, "TC_LAUNCHES"):
            mod.TC_LAUNCHES = 0


def phase_train(counters) -> dict:
    """``fit`` on full-width h2o_danube_1_8b: bf16, no remat, ``auto``
    attention (``flash_torch`` at 4096 keys), B=2 x S=4096, 6 steps,
    seed 0; then one more step of the same shapes under the profiler."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import layers as L
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_loop import LoopConfig, fit

    cfg = port_config(MODEL_ARCH)
    opts = L.ModelOptions(dtype=torch.bfloat16, remat=False,
                          attn_impl="auto")
    loop = LoopConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    log(f"train: fit {MODEL_ARCH} full width, B={TRAIN_BATCH} "
        f"S={TRAIN_SEQ}, {TRAIN_STEPS} steps")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)                # just before the train path
    r = fit(cfg, opts, loop=loop, verbose=False)
    launches = {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES for m in counters}
    peak = torch.cuda.max_memory_allocated()
    check(not any(launches.values()),
          f"the train path launched a kernel: {launches}")
    check(len(r.losses) == TRAIN_STEPS, f"{len(r.losses)} steps done")
    check(all(np.isfinite(r.losses)) and all(np.isfinite(r.grad_norms)),
          f"losses {r.losses} or grad norms {r.grad_norms} not finite")
    ln_v = float(np.log(cfg.vocab))
    check(abs(r.losses[0] - ln_v) < 1.0,
          f"first loss {r.losses[0]} is not within 1 of ln V = {ln_v}")
    measured = float(np.median(r.step_times[TIMED_STEPS]))
    log(f"train: median step {measured:.4f} s, losses {r.losses}")

    log("train: one step under the profiler")
    dev = torch.device("cuda")
    params = build_model(cfg, opts).init(torch.Generator(dev).manual_seed(0),
                                         dev)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(seed=0, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH), 0).items()}
    step = make_train_step(cfg, opts)
    params, state, _ = step(params, state, batch)      # warm
    with named_spans(TRAIN_SPANS):
        profile = device_breakdown(
            lambda: step(params, state, batch)[2]["loss"].item(), top=12,
            spans=[label for _, _, label in TRAIN_SPANS])
    del params, state, batch
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"phase": "train", "arch": MODEL_ARCH, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "dtype": "bfloat16", "remat": False, "attn_impl": "auto",
            "attn_impl_taken": "flash_torch"
            if TRAIN_SEQ > opts.flash_threshold else "naive",
            "steps": TRAIN_STEPS, "seed": 0,
            "step_seconds": r.step_times, "measured_seconds": measured,
            "measured_steps": "median of steps 2-5",
            "tokens_per_s": tokens / measured, "losses": r.losses,
            "grad_norm": r.grad_norms, "ln_vocab": ln_v,
            "peak_memory_bytes": peak, "kernel_launches": launches,
            "step_profile": profile}


def one_read_provider(port):
    """``TorchMeasuredProvider`` timing each GEMM group the reference's
    way: the GEMMs, then one fp32 ``sum`` read of each output — the
    traffic of the jitted silu + sum epilogue, which XLA fuses into one
    read. (The port's provider keeps its eager epilogue: the step it
    predicts is eager PyTorch.) Printed beside the gated prediction."""

    class OneReadProvider(port.TorchMeasuredProvider):
        @staticmethod
        def _run(inputs) -> torch.Tensor:
            acc = torch.zeros((), dtype=torch.float32,
                              device=inputs[0][0].device)
            for a, b in inputs:
                acc = acc + torch.matmul(a, b).sum(dtype=torch.float32)
            return acc

    return OneReadProvider(port.H100_CLUSTER, dtype=torch.bfloat16,
                           tf32=False)


def phase_loop_check(port, measured: float) -> dict:
    """The 1M1P1D prediction of the train phase's step (one device, one
    microbatch of B=2 x S=4096) by the measured provider (gated), by the
    same provider with a one-read epilogue and by the analytical
    provider (both printed), against the measured step."""
    from repro_torch.core.events import build_stage_events
    cfg = port_config(MODEL_ARCH)
    providers = {
        "measured": port.TorchMeasuredProvider(
            port.H100_CLUSTER, dtype=torch.bfloat16, tf32=False),
        "one_read": one_read_provider(port),
        "analytical": port.HopperAnalyticalProvider(port.H100_CLUSTER)}
    pred, seconds = {}, {}
    for name, provider in providers.items():
        t0 = time.perf_counter()
        pred[name] = port.DistSim(
            cfg, port.Strategy(), global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            provider=provider).simulate().batch_time
        seconds[name] = time.perf_counter() - t0
    ratio = {k: v / measured for k, v in pred.items()}
    (stage,) = build_stage_events(cfg, port.Strategy(), TRAIN_BATCH,
                                  TRAIN_SEQ,
                                  providers["measured"].cluster
                                  .devices_per_island)
    events: dict = {}
    for e in stage.fwd.events + stage.bwd.events:
        row = events.setdefault(e.name, {"count": 0, "flops": e.flops})
        row["count"] += 1
        for name, provider in providers.items():
            row[f"{name}_s"] = provider.time(e)
    per_event_ms = {
        name: {"eager_silu_epilogue": 1e3 * row["measured_s"],
               "one_read_epilogue": 1e3 * row["one_read_s"]}
        for name, row in events.items() if row["measured_s"] > 0}
    log(f"loop_check: predicted {pred} s, measured {measured} s")
    check(all(np.isfinite(v) and v > 0 for v in pred.values()),
          f"predictions {pred}")
    lo, hi = LOOP_BAR
    check(lo < ratio["measured"] < hi,
          f"measured-provider prediction {pred['measured']} s is "
          f"{ratio['measured']} x the measured step {measured} s")
    return {"phase": "loop_check", "arch": MODEL_ARCH,
            "strategy": port.Strategy().label(), "global_batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "cluster": port.H100_CLUSTER.name,
            "measured_step_seconds": measured,
            "predicted_measured_provider_seconds": pred["measured"],
            "predicted_analytical_provider_seconds": pred["analytical"],
            "predicted_one_read_provider_seconds": pred["one_read"],
            "ratio_measured_provider": ratio["measured"],
            "ratio_analytical_provider": ratio["analytical"],
            "ratio_one_read_provider": ratio["one_read"],
            "bar": "1/3 < ratio_measured_provider < 3",
            "provider": "TorchMeasuredProvider(dtype=bfloat16, tf32=False)",
            "one_read_provider": "the same GEMM groups, each output read "
                                 "once by sum(dtype=float32), no silu "
                                 "(ungated)",
            "per_event_ms": per_event_ms,
            "simulate_seconds": seconds, "events": events}


def phase_train_check() -> dict:
    """One fp32 train step (loss and gradients, then AdamW) of the model
    cut to CHECK_LAYERS layers, from one CPU ``torch.Generator`` draw,
    on the card and on the CPU."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import TrainConfig, value_and_grad
    from repro_torch.train.tree import leaf_paths, map_leaves

    cfg = dataclasses.replace(port_config(MODEL_ARCH), n_layers=CHECK_LAYERS)
    opts = L.ModelOptions(dtype=torch.float32, remat=False,
                          attn_impl="flash_torch")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            opts)
    batch = synth_batch(DataConfig(seed=0, vocab=cfg.vocab, seq_len=CHECK_SEQ,
                                   global_batch=CHECK_BATCH), 0)
    loss_fn = build_model(cfg, opts).loss
    out = {}
    for dev in ("cuda", "cpu"):
        log(f"train_check: one fp32 step on {dev}")
        p = map_leaves(lambda t, d=dev: t.to(d), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        loss, grads = value_and_grad(loss_fn, p, b)
        _, _, metrics = opt.update(TrainConfig().adamw, p, grads,
                                   opt.init(p))
        out[dev] = {"loss": loss.item(),
                    "grad_norm": metrics["grad_norm"].item(),
                    "seconds": time.perf_counter() - t0,
                    "grads": {k: g.cpu() for k, g in leaf_paths(grads)}}
        del p, b, grads
    gpu, cpu = out["cuda"], out["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    gnorm_rel = abs(gpu["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    leaves = {}
    for name, g in cpu["grads"].items():
        scale = float(g.abs().max())
        leaves[name] = max_abs_diff(gpu["grads"][name], g) / scale
    check(loss_rel <= CHECK_LOSS_RTOL,
          f"loss on the card {gpu['loss']}, on the CPU {cpu['loss']}")
    check(gnorm_rel <= CHECK_GNORM_RTOL,
          f"grad norm on the card {gpu['grad_norm']}, on the CPU "
          f"{cpu['grad_norm']}")
    worst = max(leaves, key=leaves.get)
    check(leaves[worst] <= CHECK_GRAD_REL,
          f"gradient {worst} differs by {leaves[worst]} x its max |g|")
    return {"phase": "train_check", "arch": MODEL_ARCH,
            "layers": CHECK_LAYERS, "batch": CHECK_BATCH, "seq": CHECK_SEQ,
            "dtype": "float32", "tf32": False, "attn_impl": "flash_torch",
            "loss": {"cuda": gpu["loss"], "cpu": cpu["loss"],
                     "rel": loss_rel, "rtol": CHECK_LOSS_RTOL},
            "grad_norm": {"cuda": gpu["grad_norm"], "cpu": cpu["grad_norm"],
                          "rel": gnorm_rel, "rtol": CHECK_GNORM_RTOL},
            "grad_leaf_rel_max": leaves, "grad_leaf_bar":
            f"{CHECK_GRAD_REL} x max |g| of the leaf",
            "seconds": {"cuda": gpu["seconds"], "cpu": cpu["seconds"]}}


# --------------------------------------------------------------------------
# the static verifier over what the serve, search and degraded phases built
# --------------------------------------------------------------------------

def phase_analyze(port, serve, search_mb, degraded) -> dict:
    """``repro_torch.analyze`` over the objects the earlier phases built,
    outside their timed windows: ``verify_megabatch`` on the clean serve
    program, the perturbed one and the search program;
    ``verify_engine`` on every engine of the serve grid;
    ``verify_perturbation`` on the serve path's straggler (for each
    strategy it perturbed) and on the degraded run's perturbation — all
    gated on zero findings. Then ``verify_cell_memory`` over the grid at
    the card's HBM, whose G010 findings (a strategy that does not fit)
    are counted, not gated."""
    from repro_torch.analyze import (verify_cell_memory, verify_engine,
                                     verify_megabatch, verify_perturbation)
    from repro_torch.core.scenario import TRAIN
    mb, mb_slow, pert = serve
    d_strat, d_pert = degraded
    seconds, findings = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        fs = fn()
        seconds[name] = time.perf_counter() - t0
        findings[name] = [str(f) for f in fs]
        log(f"analyze: {name} {len(fs)} findings, {seconds[name]:.2f}s")

    for name, prog in (("megabatch_serve", mb), ("megabatch_perturbed",
                                                  mb_slow),
                       ("megabatch_search", search_mb)):
        run(name, lambda prog=prog: verify_megabatch(prog))
    engines = list({id(e): e for e in mb.engines + mb_slow.engines}
                   .values())
    run("engines", lambda: [f for e in engines for f in verify_engine(e)])
    run("perturbations", lambda: [
        f for e in mb_slow.engines
        for f in verify_perturbation(pert, e.strat)]
        + verify_perturbation(d_pert, d_strat))
    for name, fs in findings.items():
        check(fs == [], f"analyze: {name}: {fs[:5]}")

    cfg = port_config(ARCH)
    hbm = port.H100_CLUSTER.chip.hbm_bytes
    t0 = time.perf_counter()
    g010 = [f for e in mb.engines for f in verify_cell_memory(
        cfg, e.strat, TRAIN.microbatch_size(e.strat, GLOBAL_BATCH), SEQ,
        hbm)]
    seconds["cell_memory"] = time.perf_counter() - t0
    check({f.rule for f in g010} <= {"G010"}, "cell memory: other rules")
    return {"phase": "analyze", "programs": {
                "serve": {"K": mb.K, "T": mb.T},
                "perturbed": {"K": mb_slow.K, "T": mb_slow.T},
                "search": {"K": search_mb.K, "T": search_mb.T}},
            "engines": len(engines),
            "engine_tasks": int(sum(e.total_tasks for e in engines)),
            "perturbations": {"serve": pert.label(),
                              "serve_strategies": mb_slow.K,
                              "degraded": d_pert.label()},
            "findings": sum(len(fs) for fs in findings.values()),
            "gated": sorted(findings),
            "cell_memory": {"cells": mb.K, "hbm_bytes": hbm,
                            "g010_findings": len(g010),
                            "gated": False},
            "seconds": seconds}


# --------------------------------------------------------------------------
# the model families: MoE, SSM, hybrid and encoder-decoder at full width
# --------------------------------------------------------------------------

FAMILY_DECODE_BATCH = 8
# the fp32 checks: depth cut to 2 layers (jamba keeps its one period,
# t5_large stays whole), the kernel path against the plain flash_torch
# path at FAMILY_TOL x max |logit|, decode == forward over PROMPT tokens
# at the reference's 2e-3
FAMILY_CHECK_LAYERS = 2
FAMILY_TOL = 1e-4
MOE_DISAGREE_MAX = 1e-3             # share of tokens whose experts differ


@dataclasses.dataclass(frozen=True)
class Family:
    """One config of the ``families`` line: its prefill batch (seeded
    tokens of these shapes), the K2 launches one bf16 prefill must make
    (``k2(cfg)``, all on the tensor cores; K1 and K3 none), the greedy
    decode's steps, the depth of its fp32 checks (0: the depth it runs
    at) and, where given, ``witness(cfg, params, batch)``, run on the
    bf16 weights, whose dict joins the row."""
    name: str
    arch: str
    shapes: dict
    k2: object
    decode_steps: int
    check_layers: int = FAMILY_CHECK_LAYERS
    layers: int = 0                 # a depth cut; 0: the config's own
    reduced: str = ""
    witness: object = None
    # where given, ``parallel(fa, rn, scan, mesh, cfg, params, batch,
    # logits, ms)``, run on the bf16 weights after the timed prefill
    # (``logits`` its first output, ``ms`` its median): its dict goes to
    # the ``parallel`` line
    parallel: object = None


@contextlib.contextmanager
def capture_attention(ops):
    """While the block runs, keep the first ``ops.flash_attention`` call
    of each kind (causal, bidirectional, cross: Sq != Sk) with its
    arguments; the calls go through."""
    got = {}
    real = ops.flash_attention

    def spy(q, k, v, q_pos=None, k_pos=None, **kw):
        kind = "cross" if q.shape[1] != k.shape[1] else \
            "causal" if kw.get("causal", True) else "bidirectional"
        got.setdefault(kind, (q, k, v, kw))
        return real(q, k, v, q_pos, k_pos, **kw)

    ops.flash_attention = spy
    try:
        yield got
    finally:
        ops.flash_attention = real


@contextlib.contextmanager
def record_routing(moe):
    """While the block runs, keep every MoE layer's top-k expert indices
    (``moe.router_probs``'s second output), in call order."""
    got = []
    real = moe.router_probs

    def spy(x2d, router_w, mcfg):
        out = real(x2d, router_w, mcfg)
        got.append(out[1])
        return out

    moe.router_probs = spy
    try:
        yield got
    finally:
        moe.router_probs = real


def compare_paths(out: dict, experts: dict) -> dict:
    """The prefill logits of the kernel path (``out["cuda"]``) against
    the plain path's (``out["flash_torch"]``), with each path's top-k
    experts of every MoE layer as :func:`record_routing` keeps them: the
    tokens routed differently, and the largest difference over all
    tokens, over the tokens whose experts agree, and over each
    sequence's tokens before the first whose experts differ. Only that
    last set is causally untouched by a flipped token, which reaches
    every later position through attention and the SSM scans."""
    b, s = out["cuda"].shape[:2]
    agree = torch.ones((b, s), dtype=torch.bool, device=out["cuda"].device)
    if experts["cuda"] or experts["flash_torch"]:
        check(len(experts["cuda"]) == len(experts["flash_torch"]),
              "routing not seen in both runs")
        for x, y in zip(experts["cuda"], experts["flash_torch"]):
            agree &= (torch.sort(x, dim=1).values
                      == torch.sort(y, dim=1).values).all(dim=1).view(b, s)
    before = agree.int().cummin(dim=1).values.bool()
    a, p = out["cuda"].float(), out["flash_torch"].float()
    return {"tokens": agree.numel(),
            "tokens_routed_differently": int((~agree).sum()),
            "tokens_before_first_flip": int(before.sum()),
            "max_abs_logit": float(p.abs().max()),
            "max_abs_diff": max_abs_diff(a, p),
            "max_abs_diff_agreeing": max_abs_diff(a[agree], p[agree]),
            "max_abs_diff_before_first_flip": max_abs_diff(a[before],
                                                           p[before])}


def both_paths(cfg, params, batch, dtype) -> dict:
    """One prefill under ``attn_impl="cuda"`` and one under the plain
    ``flash_torch``, compared by :func:`compare_paths`."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.train.step import make_prefill_step
    out, experts = {}, {}
    for impl in ("cuda", "flash_torch"):
        with record_routing(moe) as experts[impl]:
            out[impl] = make_prefill_step(cfg, L.ModelOptions(
                dtype=dtype, attn_impl=impl))(params, batch)
    return compare_paths(out, experts)


def dropless(cfg):
    """``cfg`` with its MoE at the dropless capacity, where no token is
    dropped and routing is causal; ``cfg`` itself without an MoE."""
    if cfg.moe is None:
        return cfg
    from repro_torch.models import moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=moe.dropless_capacity_factor(cfg.moe)))


def routing_witness(cfg, params, batch) -> dict:
    """Ungated, on the bf16 weights: the kernel path against the plain
    path at the config's capacity factor and at the dropless one, where
    capacity drops cannot spread a flipped token to other tokens."""
    return {"bf16_kernel_vs_flash_torch": {
        "config_capacity": both_paths(cfg, params, batch, torch.bfloat16),
        "dropless_capacity": both_paths(dropless(cfg), params, batch,
                                        torch.bfloat16)}}


FAMILIES = (
    Family("moe", "qwen3_moe_30b_a3b", {"tokens": (1, 4096)},
           k2=lambda cfg: cfg.n_layers, decode_steps=64,
           parallel=lambda *a: ep_prefill(*a)),
    Family("ssm", "mamba2_2_7b", {"tokens": (2, 8192)},
           k2=lambda cfg: 0, decode_steps=64),
    # jamba's 32 layers (51.5 B parameters, 103 GB in bf16) do not fit
    # one 80 GB card: one hybrid period of 8 layers does (13.3 B)
    Family("hybrid", "jamba_v0_1_52b", {"tokens": (1, 4096)},
           k2=lambda cfg: cfg.n_layers // cfg.hybrid_period,
           decode_steps=32, check_layers=0, layers=8,
           reduced="depth 32 -> 8 layers (one hybrid period): 51.5 B "
                   "parameters do not fit one 80 GB card",
           witness=routing_witness),
    Family("encdec", "t5_large", {"tokens": (2, 1024),
                                  "tokens_enc": (2, 4096)},
           k2=lambda cfg: 3 * cfg.n_layers, decode_steps=64,
           check_layers=0),
)


def counts(fa, rn, scan) -> dict:
    return {"k1": scan.LAUNCHES, "k2": fa.LAUNCHES,
            "k2_tc": fa.TC_LAUNCHES, "k3": rn.LAUNCHES}


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def family_params(cfg, dtype, seed=0):
    from repro_torch.models import api as api_mod
    from repro_torch.models import layers as L
    dev = torch.device("cuda")
    params = api_mod.build_model(cfg, L.ModelOptions(dtype=dtype)).init(
        torch.Generator(dev).manual_seed(seed), dev)
    return params, sum(t.numel() for t in _leaves(params))


def tokens(cfg, shape, seed):
    return torch.randint(0, cfg.vocab, shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed),
                         dtype=torch.int32)


def seeded_batch(cfg, shapes: dict, seed: int, rows: int = 0) -> dict:
    return {key: tokens(cfg, (rows or shape[0], shape[1]), seed + i)
            for i, (key, shape) in enumerate(shapes.items())}


def decode_cache(cfg, params, opts, batch):
    """A decode cache for ``batch``'s rows, as long as its ``tokens``;
    for the encoder-decoder, ``batch["tokens_enc"]`` encoded once and its
    cross K/V precomputed, as a server does."""
    from repro_torch.models import encdec, lm
    b, seq = batch["tokens"].shape
    if not cfg.enc_dec:
        return lm.init_cache(cfg, b, seq, opts, "cuda")
    enc = batch["tokens_enc"]
    enc_out = encdec.encode(cfg, params, params["embed"][enc.long()], opts)
    cache = encdec.init_cache(cfg, b, seq, enc.shape[1], opts, "cuda")
    cache["cross_k"], cache["cross_v"] = encdec.precompute_cross(
        cfg, params, enc_out)
    return cache


def timed_prefill(prefill, params, batch, reps=3):
    """(logits of the first run, median ms of ``reps`` runs after it)."""
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    ms = sorted(event_ms(lambda: prefill(params, batch))[1]
                for _ in range(reps))
    return logits, ms[len(ms) // 2], ms


def greedy_decode(step, params, cache, tok, steps):
    """One warm-up step, then ``steps`` greedy steps timed on the host
    clock; returns (last logits, cache, seconds)."""
    out, cache = step(params, cache, {"tokens": tok})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok = out.argmax(dim=-1, keepdim=True).to(torch.int32)
        out, cache = step(params, cache, {"tokens": tok})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(bool(torch.isfinite(out).all()), "decode logits not finite")
    return out, cache, seconds


def decode_matches_forward(cfg, params, opts, batch, cache, key="tokens"):
    """fp32: the prompt of ``batch[key]`` fed one token at a time into
    ``cache`` against the forward's logits, at the reference's bar."""
    from repro_torch.train.step import make_prefill_step, make_serve_step
    full = make_prefill_step(cfg, opts)(params, batch)
    step = make_serve_step(cfg, opts)
    prompt = batch[key]
    worst = 0.0
    for i in range(prompt.shape[1]):
        logits, cache = step(params, cache, {"tokens": prompt[:, i:i + 1]})
        want = full[:, i]
        worst = max(worst, max_abs_diff(logits, want))
        check(bool(torch.isfinite(logits).all()) and torch.allclose(
            logits, want, atol=2e-3, rtol=2e-3),
            f"{cfg.name}: fp32 decode step {i} != forward ({worst})")
    return {"dtype": "float32", "batch": prompt.shape[0],
            "prompt": prompt.shape[1], "max_abs_diff": worst,
            "max_abs_logit": float(full.abs().max()),
            "tolerance": "atol = rtol = 2e-3"}


def check_captured_k2(fa, captured: dict) -> dict:
    """The first attention of each kind the bf16 prefill ran (its layer
    0), through K2's tensor-core variant against the plain version at
    two bf16 ulps."""
    rows = {}
    for kind, (q, k, v, kw) in captured.items():
        rows[kind] = {"q": list(q.shape), "k": list(k.shape),
                      "n_rep": q.shape[2] // k.shape[2],
                      "causal": kw["causal"], "window": kw["window"],
                      "max_abs_err": check_k2_case(
                          fa, q, k, v, kw["causal"], kw["window"], True),
                      "tolerance": K2_BF16_TOL}
    return rows


def fp32_checks(spec: Family, cfg, batch) -> dict:
    """fp32, random weights, depth cut to ``spec.check_layers``, an MoE
    at the dropless capacity: where the family has attention, the
    kernel path against flash_torch on the prefill batch, at FAMILY_TOL
    x max |logit| on each sequence's tokens before the first routed
    differently, with under MOE_DISAGREE_MAX of them routed differently;
    then decode == forward over a seeded prompt."""
    from repro_torch.models import layers as L
    if spec.check_layers:
        cfg = dataclasses.replace(cfg, n_layers=spec.check_layers)
    cfg = dropless(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, _ = family_params(cfg, torch.float32)
    log(f"families: {spec.arch} fp32, {cfg.n_layers} layers"
        f"{', dropless' if cfg.moe else ''}: kernel path vs flash_torch, "
        f"decode == forward")
    row = {}
    if spec.k2(cfg):
        got = both_paths(cfg, params, batch, torch.float32)
        check(got["tokens_routed_differently"]
              <= MOE_DISAGREE_MAX * got["tokens"],
              f"{spec.arch}: {got['tokens_routed_differently']} of "
              f"{got['tokens']} tokens route differently")
        check(got["max_abs_diff_before_first_flip"]
              <= FAMILY_TOL * got["max_abs_logit"],
              f"{spec.arch} fp32 kernel path differs from flash_torch: {got}")
        row["fp32_check"] = {
            "layers": cfg.n_layers, **got,
            "capacity_factor": "dropless" if cfg.moe else None,
            "tolerance": "1e-4 x max |logit| on the tokens before the "
                         "first routed differently; under 0.1 % routed "
                         "differently"}
    opts = L.ModelOptions(dtype=torch.float32, attn_impl="cuda")
    prompt = {"tokens": tokens(cfg, (2, PROMPT), 3)}
    if cfg.enc_dec:
        prompt["tokens_enc"] = tokens(cfg, (2, 512), 6)
    row["decode_check"] = decode_matches_forward(
        cfg, params, opts, prompt, decode_cache(cfg, params, opts, prompt))
    row["decode_check"]["layers"] = cfg.n_layers
    row["fp32_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return row


def widths(cfg) -> dict:
    row = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab}
    if cfg.n_heads:
        row.update(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.head_dim)
    if cfg.d_ff:
        row["d_ff"] = cfg.d_ff
    if cfg.enc_dec:
        row["layers"] = f"{cfg.n_layers} encoder + {cfg.n_layers} decoder"
    if cfg.moe is not None:
        row.update(experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                   d_ff_expert=cfg.moe.d_ff_expert,
                   capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        row.update(d_state=cfg.ssm.d_state, ssd_head_dim=cfg.ssm.head_dim,
                   ssd_heads=cfg.d_model * cfg.ssm.expand
                   // cfg.ssm.head_dim, chunk=cfg.ssm.chunk)
    return row


def run_family(fa, rn, scan, spec: Family, mesh) -> tuple:
    """One config from a freed card: random bf16 weights; a prefill with
    the kernel counts reset just before and read just after, its layer-0
    attention of each kind held against K2's plain version; the prefill
    timed and profiled; the ``parallel`` hook and the witness, if any; a
    greedy decode timed and profiled; then, with the bf16 weights freed,
    the fp32 checks. Returns the row, the captured attention inputs and
    the hook's dict (or None)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.train.step import make_prefill_step, make_serve_step
    cfg = port_config(spec.arch)
    if spec.layers:
        cfg = dataclasses.replace(cfg, n_layers=spec.layers)
    opts = L.ModelOptions(dtype=torch.bfloat16, attn_impl="cuda")
    params, n = family_params(cfg, torch.bfloat16)
    stacks = sorted(k for k in params if k.endswith("_layers"))
    batch = seeded_batch(cfg, spec.shapes, 1)
    n_tokens = sum(t.numel() for t in batch.values())
    log(f"families: {spec.arch}, {cfg.n_layers} layers, {n} parameters; "
        f"prefill {spec.shapes}")
    prefill = make_prefill_step(cfg, opts)
    reset_launches((fa, rn, scan))
    with capture_attention(ops) as captured:
        logits = prefill(params, batch)
        torch.cuda.synchronize()
    pre = counts(fa, rn, scan)
    k2 = spec.k2(cfg)
    check(pre == {"k1": 0, "k2": k2, "k2_tc": k2, "k3": 0},
          f"{spec.arch} prefill launched {pre}, expected K2 {k2} times on "
          f"the tensor cores and nothing else")
    check(bool(torch.isfinite(logits[:, -128:]).all()),
          "prefill logits not finite")
    k2_checks = check_captured_k2(fa, captured)
    _, ms, all_ms = timed_prefill(prefill, params, batch)
    parallel = spec.parallel(fa, rn, scan, mesh, cfg, params, batch, logits,
                             ms) if spec.parallel else None
    del logits
    profile = device_breakdown(lambda: prefill(params, batch))
    witness = spec.witness(cfg, params, batch) if spec.witness else {}
    step = make_serve_step(cfg, opts)
    cache = decode_cache(cfg, params, opts, seeded_batch(
        cfg, spec.shapes, 5, rows=FAMILY_DECODE_BATCH))
    tok = tokens(cfg, (FAMILY_DECODE_BATCH, 1), 2)
    _, cache, dec_s = greedy_decode(step, params, cache, tok,
                                    spec.decode_steps)
    decode_profile = device_breakdown(lambda: [
        step(params, cache, {"tokens": tok}) for _ in range(2)])
    after = counts(fa, rn, scan)
    check(after["k1"] == after["k3"] == 0 and (k2 or after["k2"] == 0),
          f"{spec.arch} launched {after} over its run")
    peak = torch.cuda.max_memory_allocated()
    del params, cache, prefill, step
    free_card()
    prefill_row = {
        "shapes": {k: list(t.shape) for k, t in batch.items()},
        "ms_median": ms, "ms": all_ms,
        "tokens_per_s": n_tokens / ms * 1e3,
        "k2_launches": pre["k2"], "k2_tc_launches": pre["k2_tc"],
        "launches": pre, "k2_checks": k2_checks, "profile": profile}
    if cfg.moe is not None:
        prefill_row["capacity"] = moe.capacity(
            batch["tokens"].numel(), cfg.moe)
    row = {"family": spec.name, "arch": spec.arch, "parameters": n,
           **widths(cfg), "stacks": stacks, "dtype": "bfloat16",
           "prefill": prefill_row,
           "decode": {"batch": FAMILY_DECODE_BATCH,
                      "steps": spec.decode_steps, "seconds": dec_s,
                      "tokens_per_s":
                      FAMILY_DECODE_BATCH * spec.decode_steps / dec_s,
                      "profile_2_steps": decode_profile},
           **witness, "peak_memory_bytes": peak}
    if spec.reduced:
        row["reduced"] = spec.reduced
    row.update(fp32_checks(spec, cfg, batch))
    return row, captured, parallel


def phase_families(fa, rn, scan, mesh) -> tuple:
    """The configs of FAMILIES, one at a time, each from a freed card.
    Returns the line, t5's captured attention and the MoE's ``parallel``
    hook's dict."""
    rows, seconds, captured, parallel = [], {}, {}, {}
    for spec in FAMILIES:
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        row, captured[spec.name], parallel[spec.name] = run_family(
            fa, rn, scan, spec, mesh)
        seconds[spec.name] = row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        free_card()
    return {"phase": "families", "configs": rows,
            "weights": "random, torch.Generator seed 0 on the card",
            "seconds": seconds}, captured["encdec"], parallel["moe"]


def k2_cross(fa, captured) -> dict:
    """K2 on non-causal attention with Sq != Sk: seeded cases (neither
    length a multiple of the 128-key tile) in bf16 on the tensor cores at
    hd 64 and 128, within two bf16 ulps of the plain version, and in
    fp32 on the scalar kernel at 2e-5; then t5_large's captured
    cross-attention inputs, held and timed against the plain version and
    ``scaled_dot_product_attention(enable_gqa=True)``."""
    cases = []
    for sq, sk in ((1000, 1500), (1500, 1000)):
        for hd in (64, 128):
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.Generator("cuda").manual_seed(sq + hd)
                q = torch.randn((1, sq, 8, hd), generator=g,
                                device="cuda").to(dtype)
                k, v = (torch.randn((1, sk, 2, hd), generator=g,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                tc = dtype == torch.bfloat16
                e = check_k2_case(fa, q, k, v, False, None, tc)
                cases.append({"sq": sq, "sk": sk, "heads": 8, "kv_heads": 2,
                              "head_dim": hd,
                              "dtype": str(dtype).split(".")[-1],
                              "variant": "tensor_cores" if tc else "scalar",
                              "max_abs_err": e})
    q, k, v, kw = captured["cross"]
    check(not kw["causal"] and kw["window"] is None, f"cross kwargs {kw}")
    err = check_k2_case(fa, q, k, v, False, None, True)

    def kernel():
        return fa.flash_attention_cuda(q, k, v, causal=False)

    ms = timed_ms(kernel, reps=20)
    _, plain_ms = event_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                            causal=False))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)

    lib_err = max_abs_diff(library().transpose(1, 2).float(),
                           kernel().float())
    library_ms = timed_ms(library, reps=20)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    flops = 4 * hd * b * h * sq * sk
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + q.numel() * q.element_size()
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"cases": cases, "tolerance": {"bfloat16": K2_BF16_TOL,
                                          "float32": K2_FP32_TOL},
            "t5_cross": {"q": list(q.shape), "k": list(k.shape),
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms,
                         "library": "scaled_dot_product_attention("
                                    "enable_gqa=True)",
                         "library_max_abs_err": lib_err,
                         "bound_ms": max(ops_ms, bytes_ms),
                         "bound_by": "operations" if ops_ms >= bytes_ms
                         else "bytes",
                         "achieved_tflops": flops / ms / 1e9}}


#: K2's causal and windowed calls with Sq != Sk, positions aligned
#: top-left: (Sq, Sk, causal, window). Four shapes, shorter and longer
#: queries, then one whose windowed rows q >= Sk - 1 + window see no key
#: (as do those of (72, 40, False, 8)); Sk = 200 pads to 256 keys
K2_LENGTH_CASES = ((40, 72, True, None), (72, 40, True, None),
                   (72, 40, False, 8), (40, 72, True, 16),
                   (300, 200, True, 16))
#: the full-width causal case at h2o's heads: q over twice as many keys
K2_LONG = dict(b=2, sq=4096, sk=8192, h=32, kh=8, hd=80)


def k2_lengths(fa) -> dict:
    """K2 on causal and windowed attention with Sq != Sk: each case of
    K2_LENGTH_CASES at hd 64 and 80, in bf16 on the tensor cores (two
    bf16 ulps) and in fp32 on the scalar kernel (2e-5, TF32 off),
    against the plain version; then K2_LONG the same way, its bf16 call
    timed beside ``scaled_dot_product_attention`` with the same
    top-left causal band as ``attn_mask`` (the times ungated)."""
    cases = []
    for sq, sk, causal, window in K2_LENGTH_CASES:
        empty = max(0, sq - (sk - 1 + window)) if window else 0
        for hd in (64, 80):
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.Generator("cuda").manual_seed(7 * sq + sk + hd)
                q = torch.randn((1, sq, 8, hd), generator=g,
                                device="cuda").to(dtype)
                k, v = (torch.randn((1, sk, 2, hd), generator=g,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                tc = dtype == torch.bfloat16
                e = check_k2_case(fa, q, k, v, causal, window, tc)
                cases.append({"sq": sq, "sk": sk, "causal": causal,
                              "window": window, "empty_rows": empty,
                              "heads": 8, "kv_heads": 2, "head_dim": hd,
                              "dtype": str(dtype).split(".")[-1],
                              "variant": "tensor_cores" if tc
                              else "scalar", "max_abs_err": e})
    b, sq, sk, h, kh, hd = (K2_LONG[n] for n in
                            ("b", "sq", "sk", "h", "kh", "hd"))
    g = torch.Generator("cuda").manual_seed(21)
    q = torch.randn((b, sq, h, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((b, sk, kh, hd), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    err = check_k2_case(fa, q, k, v, True, None, True)
    err32 = check_k2_case(fa, q.float(), k.float(), v.float(), True, None,
                          False)

    def kernel():
        return fa.flash_attention_cuda(q, k, v, causal=True)

    out = kernel()
    ms = timed_ms(kernel, reps=10)
    i = torch.arange(sq, device="cuda")[:, None]
    band = i >= torch.arange(sk, device="cuda")[None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True)

    library_err = max_abs_diff(library().transpose(1, 2).float(),
                               out.float())
    library_ms = timed_ms(library, reps=10)
    flops = 4 * hd * band_pairs(sq, sk, True, None) * b * h
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"cases": cases, "tolerance": {"bfloat16": K2_BF16_TOL,
                                          "float32": K2_FP32_TOL},
            "long": {"q": [b, sq, h, hd], "k": [b, sk, kh, hd],
                     "causal": True, "window": None, "max_abs_err": err,
                     "fp32_max_abs_err": err32, "ms": ms,
                     "library_ms": library_ms,
                     "library": "scaled_dot_product_attention(attn_mask="
                                "top-left causal band, enable_gqa=True)",
                     "library_max_abs_err": library_err,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes",
                     "achieved_tflops": flops / ms / 1e9}}


# --------------------------------------------------------------------------
# the parallel layer on one NCCL rank
# --------------------------------------------------------------------------

PARALLEL_STEPS = 3                    # the sharded and the plain train step
# the ep_a2a prefill against the gather prefill in fp32:
# tests/test_moe.py's own bar
EP_TOL = {"atol": 1e-5, "rtol": 1e-5}
# ring attention at h2o_danube_1_8b's layer shape (b, s, h, kh, hd)
RING_SHAPE = (PREFILL_BATCH, PREFILL_SEQ, 32, 8, 80)
LAUNCHER_STEPS = 3


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL process group on the card, met through a
    ``FileStore`` in a temporary directory (no TCP port), and
    ``make_debug_mesh(1, 1)`` over it; the group is destroyed on
    leaving."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            yield make_debug_mesh(1, 1)
        finally:
            dist.destroy_process_group()


def ep_options(dtype, attn_impl):
    from repro_torch.models import layers as L
    return L.ModelOptions(dtype=dtype, attn_impl=attn_impl,
                          moe_impl="ep_a2a", ep_axis="model",
                          dp_axes=("data",))


def ep_prefill(fa, rn, scan, mesh, cfg, params, batch, gather_logits,
               gather_ms) -> dict:
    """The families phase's bf16 prefill of the MoE again, on its weights,
    with the MoE through ``ep_a2a`` over the one-rank ``model`` axis: K2
    once a layer on the tensor cores and two all-to-alls a layer (counts
    reset just before, read just after), finite logits, timed beside the
    ``gather`` prefill."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.train.step import make_prefill_step
    log(f"parallel: {cfg.name} prefill through ep_a2a on one NCCL rank")
    prefill = make_prefill_step(cfg, ep_options(torch.bfloat16, "cuda"))
    reset_launches((fa, rn, scan))
    moe.A2A_CALLS = 0
    with use_mesh(mesh):
        logits = prefill(params, batch)
        torch.cuda.synchronize()
    launches, a2a = counts(fa, rn, scan), moe.A2A_CALLS
    k2 = cfg.n_layers
    check(launches == {"k1": 0, "k2": k2, "k2_tc": k2, "k3": 0},
          f"ep_a2a prefill launched {launches}, expected K2 {k2} times on "
          f"the tensor cores and nothing else")
    check(a2a == 2 * cfg.n_layers,
          f"ep_a2a prefill made {a2a} all-to-alls, expected two a layer")
    check(bool(torch.isfinite(logits).all()), "ep_a2a logits not finite")
    diff = max_abs_diff(logits.float(), gather_logits.float())
    same = torch.equal(logits, gather_logits)
    del logits
    with use_mesh(mesh):
        _, ms, all_ms = timed_prefill(prefill, params, batch)
        profile = device_breakdown(lambda: prefill(params, batch))
    n_tokens = batch["tokens"].numel()
    return {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16",
            "shapes": {k: list(t.shape) for k, t in batch.items()},
            "capacity": moe.capacity(n_tokens, cfg.moe),
            "k2_launches": launches["k2"], "k2_tc_launches": launches["k2_tc"],
            "launches": launches, "all_to_all_calls": a2a,
            "ms_median": ms, "ms": all_ms,
            "tokens_per_s": n_tokens / ms * 1e3,
            "gather_ms_median": gather_ms,
            "gather_tokens_per_s": n_tokens / gather_ms * 1e3,
            "bf16_max_abs_diff_vs_gather": diff,
            "bf16_identical_to_gather": same, "profile": profile}


def ep_fp32_check(mesh) -> dict:
    """fp32, the MoE cut to 2 layers: the ``ep_a2a`` prefill against the
    ``gather`` prefill at tests/test_moe.py's 1e-5, at the config's
    capacity and at the dropless one."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.train.step import make_prefill_step
    spec = FAMILIES[0]
    cfg = dataclasses.replace(port_config(spec.arch),
                              n_layers=FAMILY_CHECK_LAYERS)
    params, _ = family_params(cfg, torch.float32)
    batch = seeded_batch(cfg, spec.shapes, 1)
    log(f"parallel: {spec.arch} fp32, {cfg.n_layers} layers: ep_a2a vs "
        f"gather")
    rows = {}
    for name, c in (("config_capacity", cfg),
                    ("dropless_capacity", dropless(cfg))):
        want = make_prefill_step(c, L.ModelOptions(
            dtype=torch.float32, attn_impl="flash_torch"))(params, batch)
        with use_mesh(mesh):
            got = make_prefill_step(c, ep_options(
                torch.float32, "flash_torch"))(params, batch)
        e = max_abs_diff(got, want)
        check(torch.allclose(got, want, **EP_TOL),
              f"fp32 ep_a2a != gather at the {name} ({e})")
        rows[name] = {"capacity": moe.capacity(batch["tokens"].numel(),
                                               c.moe),
                      "max_abs_diff": e,
                      "max_abs_logit": float(want.abs().max()),
                      "identical": torch.equal(got, want)}
        del got, want
    del params
    free_card()
    return {"layers": cfg.n_layers, "dtype": "float32",
            "attn_impl": "flash_torch", "tolerance": "atol = rtol = 1e-5",
            **rows}


def self_transfer(mesh) -> str:
    """Whether ``batch_isend_irecv`` from this rank to itself round-trips
    on the mesh's NCCL group (gloo refuses it; the one-rank ring sends
    nothing either way): "allowed", or the error, ungated."""
    import torch.distributed as dist
    group = mesh.get_group("model")
    x = torch.arange(8.0, device="cuda")
    y = torch.empty_like(x)
    me = dist.get_rank()
    try:
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, me, group),
                dist.P2POp(dist.irecv, y, me, group)]):
            r.wait()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return f"refused: {e}"[:300]
    check(torch.equal(x, y), "a transfer to this rank came back changed")
    return "allowed"


def ring_check(mesh) -> dict:
    """Ring attention over the one-rank ``model`` axis at h2o's layer
    shape against ``attention_flash_torch`` on the same inputs: one
    partial, combined at weight exp(0) = 1, must give the same bits."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import use_mesh
    b, s, h, kh, hd = RING_SHAPE
    window = port_config(MODEL_ARCH).sliding_window
    q, k, v = seeded_qkv(RING_SHAPE, torch.bfloat16, seed=11)
    pos = torch.arange(s, device="cuda").expand(b, s)
    log(f"parallel: ring attention on one rank, q {(b, s, h, hd)}")
    with torch.no_grad(), use_mesh(mesh):
        def ring():
            return L.ring_attention(q, k, v, pos, pos, "model", True, window)

        def plain():
            return L.attention_flash_torch(q, k, v, pos, pos, True, window)

        got, want = ring(), plain()
        same = torch.equal(got.view(torch.int16), want.view(torch.int16))
        check(same, f"ring attention != flash_torch on one rank "
                    f"(max abs diff {max_abs_diff(got.float(), want.float())})")
        ring_ms = sorted(event_ms(ring)[1] for _ in range(3))
        plain_ms = sorted(event_ms(plain)[1] for _ in range(3))
    return {"q": [b, s, h, hd], "k": [b, s, kh, hd], "dtype": "bfloat16",
            "causal": True, "window": window, "axis": "model", "ranks": 1,
            "bit_identical": same, "ms_median": ring_ms[1], "ms": ring_ms,
            "flash_torch_ms_median": plain_ms[1], "flash_torch_ms": plain_ms,
            "transfers": 0, "nccl_send_to_self": self_transfer(mesh)}


def run_steps(step, params, make_state, batch) -> tuple:
    """PARALLEL_STEPS chained steps from ``params`` and ``make_state()``
    (made here, so no caller holds the first state); each step's loss,
    gradient norm and host seconds, and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    p, st = params, make_state()
    losses, norms, secs = [], [], []
    for _ in range(PARALLEL_STEPS):
        t0 = time.perf_counter()
        p, st, m = step(p, st, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        secs.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"losses {losses} or grad norms {norms} not finite")
    return {"losses": losses, "grad_norms": norms, "step_seconds": secs,
            "seconds_median": float(np.median(secs)),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}, p


def sharded_step(mesh) -> tuple:
    """Full-width h2o_danube_1_8b, B=2 x S=4096 bf16, no remat, ``auto``
    attention: PARALLEL_STEPS plain steps, then, the plain copy freed,
    the same parameters placed as DTensors on the (1, 1) mesh
    (``param_specs(fsdp_axes="data")``, moments by ``zero1_specs``)
    through ``make_train_step(grad_specs=)``, attention through its local
    map. Returns the row and the placed step's gradient tree (the first
    step's), local views."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import layers as L
    from repro_torch.models.api import build_model
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step, value_and_grad
    from repro_torch.train.tree import leaves, map_leaves
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = port_config(MODEL_ARCH)
    opts = L.ModelOptions(dtype=torch.bfloat16, remat=False,
                          attn_impl="auto")
    dev = torch.device("cuda")
    api = build_model(cfg, opts)
    params = api.init(torch.Generator(dev).manual_seed(0), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(seed=0, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH), 0).items()}
    log(f"parallel: {PARALLEL_STEPS} plain steps of {MODEL_ARCH}")
    plain, last = run_steps(make_train_step(cfg, opts), params,
                            lambda: opt.init(params), batch)
    del last
    free_card()
    log(f"parallel: {PARALLEL_STEPS} steps on DTensors over the (1, 1) "
        f"mesh")
    pspecs = sh.param_specs(params, mesh, fsdp_axes="data")
    dparams = sh.distribute_tree(params, pspecs, mesh)
    del params
    free_card()
    shapes = map_leaves(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), dparams)
    ospecs = sh.zero1_specs(opt.init(shapes), opt.state_specs(pspecs), mesh)
    step = make_train_step(cfg, opts, grad_specs=pspecs)
    with sh.use_mesh(mesh):
        sharded, last = run_steps(
            step, dparams,
            lambda: sh.distribute_tree(opt.init(dparams), ospecs, mesh),
            batch)
    placed = all(sh.is_dtensor(t) for t in leaves(last))
    check(placed, "the sharded step returned plain parameters")
    del last
    free_card()
    loss_rel = abs(sharded["losses"][0] - plain["losses"][0]) \
        / abs(plain["losses"][0])
    gnorm_rel = abs(sharded["grad_norms"][0] - plain["grad_norms"][0]) \
        / plain["grad_norms"][0]
    check(loss_rel <= CHECK_LOSS_RTOL,
          f"sharded first loss {sharded['losses'][0]}, plain "
          f"{plain['losses'][0]}")
    check(gnorm_rel <= CHECK_GNORM_RTOL,
          f"sharded first grad norm {sharded['grad_norms'][0]}, plain "
          f"{plain['grad_norms'][0]}")
    with sh.use_mesh(mesh), implicit_replication():
        _, grads = value_and_grad(api.loss, dparams, batch)
    grads = map_leaves(sh.local, grads)
    del dparams
    free_card()
    spec_set = sorted({str(p) for p in sh.spec_leaves(pspecs)})
    return {"arch": MODEL_ARCH, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "dtype": "bfloat16", "remat": False,
            "attn_impl": "auto", "steps": PARALLEL_STEPS,
            "param_specs": "param_specs(fsdp_axes='data'); moments "
                           "zero1_specs(state_specs(...))",
            "distinct_param_specs": spec_set,
            "plain": plain, "sharded": sharded,
            "first_loss_rel": loss_rel, "first_grad_norm_rel": gnorm_rel,
            "first_loss_identical":
                sharded["losses"][0] == plain["losses"][0],
            "first_grad_norm_identical":
                sharded["grad_norms"][0] == plain["grad_norms"][0],
            "bars": {"loss_rtol": CHECK_LOSS_RTOL,
                     "grad_norm_rtol": CHECK_GNORM_RTOL},
            "dtensor_seconds_ratio":
                sharded["seconds_median"] / plain["seconds_median"],
            "returned_dtensors": placed}, grads


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def compression_check(mesh, grads) -> dict:
    """``compressed_psum`` over the one-rank ``data`` group on the whole
    gradient tree, then ``ErrorFeedback.apply`` from a zero residual:
    with one rank the sum is the code and the max the scale, so each leaf
    must be ``dequantize_int8(*quantize_int8(g))``'s bits."""
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.train import compression as C
    from repro_torch.train.tree import leaves
    n = sum(g.numel() for g in leaves(grads))
    log(f"parallel: compressed_psum over {n} gradient elements")
    with use_mesh(mesh):
        C.compressed_psum({"w": leaves(grads)[0]}, "data")      # warm
        torch.cuda.synchronize()
        out, psum_ms = event_ms(lambda: C.compressed_psum(grads, "data"))
    for g, o in zip(leaves(grads), leaves(out)):
        want = C.dequantize_int8(*C.quantize_int8(g)).to(g.dtype)
        check(same_bits(o, want), "compressed_psum on one rank is not "
                                  "dequantize(quantize(g))")
    del out
    (sent, resid), ef_ms = event_ms(lambda: C.ErrorFeedback.apply(
        grads, C.ErrorFeedback.init(grads)))
    for g, s_, r in zip(leaves(grads), leaves(sent), leaves(resid)):
        deq = C.dequantize_int8(*C.quantize_int8(g))
        check(same_bits(s_, deq.to(g.dtype)) and same_bits(
            r, g.float() - deq), "ErrorFeedback.apply from zero is not "
                                 "the quantization and its residual")
    del sent, resid
    wire = C.wire_bytes(grads)
    tree = sum(g.numel() * g.element_size() for g in leaves(grads))
    return {"elements": n, "leaves": len(leaves(grads)),
            "dtype": str(leaves(grads)[0].dtype).replace("torch.", ""),
            "psum_ms": psum_ms, "error_feedback_ms": ef_ms,
            "bit_identical": True, "wire_bytes_int32": wire,
            "tree_bytes": tree, "wire_over_tree": wire / tree}


def launcher_check(cfg) -> dict:
    """``python -m repro_torch.launch.train --arch <MODEL_ARCH> --steps 3``
    in a child process with the reference CLI's defaults (fp32, seq 256,
    batch 8, on the card): exit 0, finite losses, the first within 1 of
    ln V."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           MODEL_ARCH, "--steps", str(LAUNCHER_STEPS)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    log(f"parallel: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=env, cwd=HERE)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"launcher exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    logged = [float(x) for x in re.findall(r"^step\s+\d+ loss\s+(\S+)",
                                           proc.stdout, re.M)]
    done = re.search(r"done: loss (\S+) \S+ (\S+) \((\d+) steps\)",
                     proc.stdout)
    check(done is not None, f"no summary line: {proc.stdout[-1000:]}")
    first, last = float(done.group(1)), float(done.group(2))
    ln_v = float(np.log(cfg.vocab))
    check(all(np.isfinite(logged + [first, last])),
          f"launcher losses not finite: {proc.stdout[-1000:]}")
    check(abs(first - ln_v) < 1.0,
          f"launcher's first loss {first} is not within 1 of ln V = {ln_v}")
    return {"command": " ".join(["python"] + cmd[1:]),
            "defaults": "fp32, seq 256, batch 8, no remat, device cuda",
            "returncode": proc.returncode, "logged_losses": logged,
            "first_loss": first, "last_loss": last,
            "steps": int(done.group(3)), "ln_vocab": ln_v,
            "seconds": seconds}


def phase_parallel(mesh, ep_row) -> dict:
    """The parallel layer on one NCCL rank, after the families phase:
    the MoE's ep_a2a prefill (run there, on its weights) with its fp32
    check, ring attention, the sharded train step, compressed gradient
    all-reduce and the launcher."""
    seconds = {}
    t0 = time.perf_counter()
    ep_row["fp32_check"] = ep_fp32_check(mesh)
    seconds["ep_fp32_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ring = ring_check(mesh)
    free_card()
    seconds["ring"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step_row, grads = sharded_step(mesh)
    seconds["sharded_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compression = compression_check(mesh, grads)
    del grads
    free_card()
    seconds["compression"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launcher = launcher_check(port_config(MODEL_ARCH))
    seconds["launcher"] = time.perf_counter() - t0
    import torch.distributed as dist
    return {"phase": "parallel",
            "process_group": {"backend": dist.get_backend(),
                              "world_size": dist.get_world_size(),
                              "rendezvous": "FileStore in a temporary "
                                            "directory"},
            "mesh": {"shape": list(mesh.mesh.shape),
                     "axes": list(mesh.mesh_dim_names),
                     "device": mesh.device_type},
            "ep_a2a": ep_row, "ring": ring, "sharded_step": step_row,
            "compression": compression, "launcher": launcher,
            "seconds": seconds}


# the dry run: full-width cells traced on the production meshes over a
# fake process group, each in a child process of its own, all at once;
# (arch, shape, mesh, layers): qwen3_moe's prefill_32k is cut to 4 of its
# 48 layers (its flash_torch loops over ~1 000 live block pairs a layer
# in Python: ~11 s a layer on a CPU core) and mamba2's train_4k to 16 of
# its 64 (the trace grows with the depth), the rest are traced whole.
# The decode cells run the MoE's gather and the enc-dec's cross-attention
# on DTensors (whisper's 6 heads over 16 ranks), mamba2 its SSM blocks
# split over `model` by heads, t5 one attention head a rank. The last six
# hold one repair each to the reference: qwen2's train step (the
# vocab-parallel cross-entropy, its 12 heads padded to 16), gpt2's (a
# vocabulary of 50257, each rank's rows by the whole head), phi3's
# prefill (40 heads padded to 48), the SSM decode step where the cache is
# placed (mamba2; jamba, its state split by its batch) and jamba's
# prefill (the dense FFN split over `model`).
DRYRUN_CELLS = (("h2o_danube_1_8b", "train_4k", "single", None),
                ("h2o_danube_1_8b", "train_4k", "multi", None),
                ("qwen3_moe_30b_a3b", "prefill_32k", "single", 4),
                ("mistral_large_123b", "decode_32k", "single", None),
                ("qwen3_moe_30b_a3b", "decode_32k", "single", 2),
                ("whisper_tiny", "decode_32k", "single", None),
                ("mamba2_2_7b", "train_4k", "single", 16),
                ("t5_large", "train_4k", "single", None),
                ("qwen2_1_5b", "train_4k", "single", 1),
                ("gpt2_345m", "train_4k", "single", 1),
                ("phi3_medium_14b", "prefill_32k", "single", 1),
                ("mamba2_2_7b", "decode_32k", "single", 1),
                ("jamba_v0_1_52b", "decode_32k", "single", 8),
                ("jamba_v0_1_52b", "prefill_32k", "single", 8))
DRYRUN_TIMEOUT = 600
#: per-device FLOPs and collective bytes of cells of DRYRUN_CELLS as the
#: reference's own dry run counts them (``repro.launch.dryrun``, XLA's
#: ``hlo_stats``, on 16 x 16 at the same depth), made by
#:   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_dryrun_ref.py \
#:     --production ref.json qwen3_moe_30b_a3b:decode_32k:2 \
#:     whisper_tiny:decode_32k:4 qwen2_1_5b:train_4k:1 gpt2_345m:train_4k:1 \
#:     phi3_medium_14b:prefill_32k:1 mamba2_2_7b:decode_32k:1 \
#:     jamba_v0_1_52b:decode_32k:8 jamba_v0_1_52b:prefill_32k:8
#: (``flops`` and ``total``); ``tests/test_torch_dryrun_held_*.py`` hold
#: every cell at one layer to the live reference on the CPU. Held here
#: on the card's torch, whose DTensor chooses other strategies: the
#: collective bytes at most DRYRUN_TOL over; the FLOPs within DRYRUN_TOL
#: where no block pair is skipped (decode), at most DRYRUN_TOL over where
#: the port's blockwise attention skips pairs (train, prefill) or the
#: reference does work the port does not (gpt2's head on every chunk of
#: each rank's rows, jamba's dense down product whole on every rank).
DRYRUN_REFERENCE_FLOPS = {("qwen3_moe_30b_a3b", "decode_32k"): 3022782464,
                          ("whisper_tiny", "decode_32k"): 477911040,
                          ("qwen2_1_5b", "train_4k"): 7774427676672,
                          ("gpt2_345m", "train_4k"): 10805265301504,
                          ("phi3_medium_14b", "prefill_32k"): 10299331575808,
                          ("mamba2_2_7b", "decode_32k"): 2100327424,
                          ("jamba_v0_1_52b", "decode_32k"): 53523003392,
                          ("jamba_v0_1_52b", "prefill_32k"): 59755041128448}
DRYRUN_REFERENCE_COLL = {("qwen3_moe_30b_a3b", "decode_32k"): 4884640.0,
                         ("whisper_tiny", "decode_32k"): 4981152.0,
                         ("qwen2_1_5b", "train_4k"): 5474411007.25,
                         ("gpt2_345m", "train_4k"): 2986530800.25,
                         ("phi3_medium_14b", "prefill_32k"): 4865392640.0,
                         ("mamba2_2_7b", "decode_32k"): 121020.0,
                         ("jamba_v0_1_52b", "decode_32k"): 127182752.0,
                         ("jamba_v0_1_52b", "prefill_32k"): 25214934592.0}
#: per-device FLOPs as run (the causal skip in) of the cells of
#: DRYRUN_REFERENCE_FLOPS whose bar above is one-sided, as the port's own
#: dry run traces them on the CPU (torch 2.13.0+cpu), made by
#:   PYTHONPATH=src python -m repro_torch.launch.dryrun --arch <arch> \
#:     --shape <shape> --multi-pod single --layers <layers> --device cpu
#: (``hlo_flops/dev``): held within DRYRUN_TOL, two-sided, on the card.
DRYRUN_PORT_FLOPS = {("qwen2_1_5b", "train_4k"): 7.542e12,
                     ("gpt2_345m", "train_4k"): 1.836e12,
                     ("phi3_medium_14b", "prefill_32k"): 8.702e12,
                     ("jamba_v0_1_52b", "prefill_32k"): 2.983e13}
DRYRUN_TOL = 0.10
# the roofline held to the train phase's measured step (its model,
# batch and options): traced FLOPs == FlopCounterMode's, the predicted
# peak within 10 % of max_memory_allocated, the bound <= the median step
ROOFLINE_PEAK_TOL = 0.10
ROOFLINE_STEPS = 4
# the ring's backward on one NCCL rank at h2o's layer 0 (S = 8192)
# against flash_torch's, in fp32 at 2e-5 (TF32 off) and in bf16 (ulps)
RING_GRAD_TOL = 2e-5


def start_dryrun_cells(out_dir: str) -> list:
    """Start each of DRYRUN_CELLS as ``python -m repro_torch.launch.dryrun``
    in a child process (one CPU thread each), writing its CSV under
    ``out_dir``; returns (cell, process, csv path, start time)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    started = []
    for i, (arch, shape, pods, layers) in enumerate(DRYRUN_CELLS):
        out = os.path.join(out_dir, f"cell{i}.csv")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--multi-pod", pods, "--out", out,
               "--device", "cuda"]
        if layers:
            cmd += ["--layers", str(layers)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=HERE)
        started.append(((arch, shape, pods, layers), proc, out,
                        time.perf_counter()))
    return started


def finish_dryrun_cells(started) -> list:
    """Wait for every cell; each must lower with all three terms > 0."""
    rows = []
    try:
        for (arch, shape, pods, layers), proc, out, t0 in started:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"dry run of {arch}/{shape}/{pods} exited "
                  f"{proc.returncode}: {stdout[-1500:]} {stderr[-1500:]}")
            with open(out) as f:
                header, row = f.read().splitlines()
            fields = dict(zip(header.split(","), row.split(",")))
            terms = [float(fields[k]) for k in
                     ("t_compute_ms", "t_memory_ms", "t_coll_ms")]
            # each term is its count over a rate: gated on the counts,
            # as the CSV rounds a decode cell's terms to 0.000 ms
            counts = [float(fields[k]) for k in
                      ("hlo_flops/dev", "hlo_bytes/dev", "coll_bytes/dev")]
            check(all(c > 0 for c in counts),
                  f"{arch}/{shape}/{pods}: a roofline term is not > 0: {row}")
            want = DRYRUN_REFERENCE_FLOPS.get((arch, shape))
            low = (1 - DRYRUN_TOL) * want if want and shape.startswith(
                ("decode", "long")) else 0.0
            check(want is None
                  or low <= counts[0] <= (1 + DRYRUN_TOL) * want,
                  f"{arch}/{shape}/{pods}: {counts[0]:.4e} FLOPs a device, "
                  f"the reference's {want}")
            port = DRYRUN_PORT_FLOPS.get((arch, shape))
            check(port is None or abs(counts[0] - port) <= DRYRUN_TOL * port,
                  f"{arch}/{shape}/{pods}: {counts[0]:.4e} FLOPs a device, "
                  f"the port's on the CPU {port}")
            want_coll = DRYRUN_REFERENCE_COLL.get((arch, shape))
            check(want_coll is None
                  or counts[2] <= (1 + DRYRUN_TOL) * want_coll,
                  f"{arch}/{shape}/{pods}: {counts[2]:.4e} collective bytes "
                  f"a device, the reference's {want_coll}")
            traced = re.search(r"trace ([\d.]+)s", stdout)
            peak = re.search(r"memory: peak (\S+) B, arguments (\S+) B",
                             stdout)
            rows.append({"arch": arch, "shape": shape,
                         "mesh": fields["mesh"], "chips": int(fields["chips"]),
                         "layers": layers or port_config(arch).n_layers,
                         "layers_full": port_config(arch).n_layers,
                         "row": row, "t_compute_ms": terms[0],
                         "t_memory_ms": terms[1], "t_coll_ms": terms[2],
                         "flops_per_device": counts[0],
                         "reference_flops_per_device": want,
                         "cpu_flops_per_device": port,
                         "bytes_per_device": counts[1],
                         "collective_bytes_per_device": counts[2],
                         "reference_collective_bytes_per_device": want_coll,
                         "dominant": fields["dominant"],
                         "peak_bytes_per_device": float(peak.group(1)),
                         "argument_bytes": float(peak.group(2)),
                         "trace_seconds": float(traced.group(1)),
                         "process_seconds": wall})
    finally:
        for _, proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rows


def roofline_check() -> dict:
    """The train phase's step — full-width h2o_danube_1_8b, bf16, no remat,
    ``auto`` attention, B=2 x S=4096, plain tensors (a 1 x 1 mesh places
    nothing) — traced on fake tensors and run on the card: the traced
    FLOPs must equal FlopCounterMode's count of the real step, the
    predicted peak be within ROOFLINE_PEAK_TOL of max_memory_allocated,
    and the roofline bound be no more than the measured median step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import roofline
    from repro_torch.core.hw import H100
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models import layers as L
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    cfg = port_config(MODEL_ARCH)
    opts = L.ModelOptions(dtype=torch.bfloat16, remat=False,
                          attn_impl="auto")
    dev = torch.device("cuda")
    free_card()
    base = torch.cuda.memory_allocated()
    params = build_model(cfg, opts).init(torch.Generator(dev).manual_seed(0),
                                         dev)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        DataConfig(seed=0, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH), 0).items()}
    step = make_train_step(cfg, opts)
    log("dryrun: the real step under FlopCounterMode")
    # the trace's formulas: torch 2.11's bmm formula refuses bmm.dtype
    # (the bf16 score products with out_dtype=float32), and its conv
    # backward formula ignores groups
    counter = FlopCounterMode(display=False,
                              custom_mapping=roofline.CUSTOM_FLOPS)
    with counter:
        step(params, state, batch)
    real_flops = counter.get_total_flops()
    del counter
    free_card()
    torch.cuda.reset_peak_memory_stats()
    step(params, state, batch)
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated() - base
    secs = []
    p, st = params, state
    del params, state
    for _ in range(ROOFLINE_STEPS + 1):
        t0 = time.perf_counter()
        p, st, m = step(p, st, batch)
        m["loss"].item()
        secs.append(time.perf_counter() - t0)
    measured = float(np.median(secs[1:]))
    del p, st, m, batch
    free_card()

    log("dryrun: the same step traced on fake tensors")
    t0 = time.perf_counter()
    shape = ShapeConfig("roofline_check", TRAIN_SEQ, TRAIN_BATCH, "train")
    stats, tracer, peak, args = trace_step(cfg, shape, opts, None,
                                           device=dev)
    trace_s = time.perf_counter() - t0
    rep = roofline.analyze_trace(MODEL_ARCH, shape.name, "1x1", 1, stats,
                                 0.0, H100, peak_bytes=peak)
    bound = rep.step_time_bound
    check(stats["flops"] == real_flops,
          f"traced FLOPs {stats['flops']} != FlopCounterMode's {real_flops}")
    peak_rel = abs(peak - real_peak) / real_peak
    check(peak_rel <= ROOFLINE_PEAK_TOL,
          f"predicted peak {peak} vs max_memory_allocated {real_peak}")
    check(bound <= measured,
          f"roofline bound {bound} s exceeds the measured step {measured} s")
    from repro_torch.core.hlo_diag import top_ops
    return {"arch": MODEL_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "dtype": "bfloat16", "remat": False, "attn_impl": "auto",
            "traced_flops": stats["flops"], "flop_counter_flops": real_flops,
            "flops_equal": stats["flops"] == real_flops,
            "traced_bytes": stats["bytes"],
            "predicted_peak_bytes": peak, "argument_bytes": args,
            "max_memory_allocated": real_peak,
            "peak_rel_diff": peak_rel, "peak_bar": ROOFLINE_PEAK_TOL,
            "t_compute_ms": rep.t_compute * 1e3,
            "t_memory_ms": rep.t_memory * 1e3,
            "t_coll_ms": rep.t_collective * 1e3, "dominant": rep.dominant,
            "bound_seconds": bound, "measured_seconds": measured,
            "step_seconds": secs, "measured_over_bound": measured / bound,
            "trace_seconds": trace_s,
            "top_ops": [list(r) for r in top_ops(tracer.records, 8)]}


def ring_backward_check(mesh) -> dict:
    """The ring's backward over the one-rank ``model`` axis at h2o's layer
    0 (S = 8192, window 4096) against ``flash_torch``'s on the same
    inputs and output weights: fp32 within RING_GRAD_TOL (TF32 off), and
    bf16's largest difference in ulps."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import use_mesh
    b, s, h, kh, hd = RING_SHAPE
    window = port_config(MODEL_ARCH).sliding_window
    pos = torch.arange(s, device="cuda").expand(b, s)
    out = {"q": [b, s, h, hd], "k": [b, s, kh, hd], "window": window,
           "axis": "model", "ranks": 1}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k, v = seeded_qkv(RING_SHAPE, dtype, seed=12)
        ct = torch.randn((b, s, h, hd), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(13))

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            (fn(*leaves).float() * ct).sum().backward()
            return [t.grad for t in leaves]

        with use_mesh(mesh):
            t0 = time.perf_counter()
            got = grads(lambda q, k, v: L.ring_attention(
                q, k, v, pos, pos, "model", True, window))
            torch.cuda.synchronize()
            ring_s = time.perf_counter() - t0
        want = grads(lambda q, k, v: L.attention_flash_torch(
            q, k, v, pos, pos, True, window))
        row = {"ring_seconds": ring_s,
               "max_abs_diff": {g: max_abs_diff(a.float(), w.float())
                                for g, a, w in zip("qkv", got, want)},
               "bit_identical": all(torch.equal(a, w)
                                    for a, w in zip(got, want))}
        if dtype == torch.float32:
            for g, a, w in zip("qkv", got, want):
                check(torch.allclose(a, w, atol=RING_GRAD_TOL,
                                     rtol=RING_GRAD_TOL),
                      f"ring d{g} != flash_torch's in fp32: "
                      f"{row['max_abs_diff']}")
            row["tol"] = RING_GRAD_TOL
        else:
            row["max_ulps"] = {g: bf16_ulps(a, w)
                               for g, a, w in zip("qkv", got, want)}
        out[name] = row
        del q, k, v, ct, got, want
        free_card()
    return out


def phase_dryrun(ring_row) -> dict:
    """The dry run's full-width cells, each traced in a child process
    while this process holds the roofline to the measured step."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        log(f"dryrun: {len(DRYRUN_CELLS)} cells in child processes")
        started = start_dryrun_cells(tmp)
        try:
            check_row = roofline_check()
        finally:
            cells = finish_dryrun_cells(started)
    return {"phase": "dryrun", "cells": cells, "roofline_check": check_row,
            "ring_backward": ring_row,
            "nvidia_smi": run_text(["nvidia-smi",
                                    "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"]),
            "seconds": time.perf_counter() - t0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False. There is no CPU mode.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch.core as port
    import repro_torch.store as store_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import megabatch_scan as scan
    from repro_torch.kernels import rmsnorm as rn

    # fp32 products in IEEE fp32 everywhere (these are the defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = torch.device("cuda")
    env = phase_env()
    emit(env)
    log("build: compiling the kernels")
    emit(phase_build((scan, fa, rn)))
    log("kernels: K1 on random programs")
    random_rows = check_random_programs(scan, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
        serve_line, mb, launches, slow = phase_serve(port, store_mod, scan,
                                                     store)
    k1 = kernel_k1(scan, mb, launches, random_rows)
    torch.cuda.empty_cache()
    search_mb, search_line = phase_search(port, scan)
    k1["search_launches"] = search_line["kernel_launches"]
    torch.cuda.empty_cache()
    degraded, degraded_line = phase_degraded(port)
    log("analyze: the verifier over the serve, search and degraded objects")
    analyze_line = phase_analyze(port, (mb, *slow), search_mb, degraded)
    del mb, slow, search_mb
    torch.cuda.empty_cache()
    log("profile: measured provider on the card")
    profile_line = phase_profile(port)

    model_line, captured, model_launches = phase_model(fa, rn)
    k2 = kernel_k2(fa, captured, model_launches["flash_attention"],
                   model_launches["flash_attention_tc"])
    k3 = kernel_k3(rn, captured, model_launches["rmsnorm"])
    del captured
    torch.cuda.empty_cache()

    with one_rank_mesh() as mesh:
        families_line, t5_attention, ep_row = phase_families(fa, rn, scan,
                                                             mesh)
        log("kernels: K2 on cross-attention (Sq != Sk)")
        k2["cross"] = k2_cross(fa, t5_attention)
        log("kernels: K2 on causal and windowed calls with Sq != Sk")
        k2["lengths"] = k2_lengths(fa)
        k2["families"] = {
            row["arch"]: {"k2": row["prefill"]["k2_launches"],
                          "k2_tc": row["prefill"]["k2_tc_launches"],
                          "checks": row["prefill"]["k2_checks"]}
            for row in families_line["configs"]}
        k2["ep_a2a_launches"] = ep_row["k2_launches"]
        del t5_attention
        free_card()
        parallel_line = phase_parallel(mesh, ep_row)
        free_card()
        log("dryrun: the ring's backward on one rank")
        t0 = time.perf_counter()
        ring_row = ring_backward_check(mesh)
        ring_row["seconds"] = time.perf_counter() - t0
    free_card()

    train_line = phase_train((scan, fa, rn))
    loop_line = phase_loop_check(port, train_line["measured_seconds"])
    check_line = phase_train_check()
    free_card()
    dryrun_line = phase_dryrun(ring_row)

    emit({"kernels": [k1, k2, k3]})
    emit(profile_line)
    emit(model_line)
    emit(serve_line)
    emit(search_line)
    emit(degraded_line)
    emit(analyze_line)
    emit(families_line)
    emit(parallel_line)
    emit(train_line)
    emit(loop_line)
    emit(check_line)
    dryrun_line["total_seconds"] = time.perf_counter() - t_start
    emit(dryrun_line)
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
