"""Multi-pod dry run: the port of the reference package's
``repro.launch.dryrun``.

Traces one step of every (architecture x input shape x mesh) cell on
the production meshes — (16, 16) = 256 ranks single-pod and
(2, 16, 16) = 512 ranks multi-pod — and records each cell's roofline
terms per device (:mod:`repro_torch.core.roofline`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch qwen2_1_5b] [--shape train_4k] [--multi-pod both] \\
        [--out results/dryrun.csv] [--device cpu|cuda] [--smoke]
        [--layers N]

Nothing runs on a device and no memory is allocated: the process group
is PyTorch's fake backend (``init_process_group("fake", store=
FakeStore(), rank=0, world_size=n)``, with ``FakeStore`` from the
private module ``torch.testing._internal.distributed.fake_pg``), the
parameters, optimizer state, batch and cache are fake tensors placed as
DTensors, and the step runs once under
:class:`~repro_torch.core.roofline.TraceCounter`, which counts FLOPs,
eager bytes and collectives on one rank's local shards. The peak bytes
per device come from ``torch.distributed._tools.mem_tracker.MemTracker``
over the same call (the counterpart of ``memory_analysis()``'s temp +
argument + output). The counts are those of the rank that bounds the
step (:func:`traced_rank`): rank 0, except under ``--mapping fsdp_cp``,
whose causal sequence split over ``model`` leaves rank 0 the least work
and the last ``model`` coordinate the most. The dry run needs no card;
``--device`` (default ``cuda``, which must exist) is the device the
fake tensors name.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import (SHAPES, arch_shapes, get_config,
                                      list_archs, smoke_config)
from repro_torch.core import roofline
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.hw import H100
from repro_torch.core.modelgraph import model_flops_per_token
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models.api import build_model, make_batch
from repro_torch.models.layers import ModelOptions
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.train import optimizer as optlib
from repro_torch.train.step import (TrainConfig, make_prefill_step,
                                    make_serve_step, make_train_step)
from repro_torch.train.tree import leaves


def model_options(cfg, shape, mesh, baseline: bool = False,
                  mapping: str = "tp_sp") -> ModelOptions:
    """Per-cell runtime knobs, the reference's rule for rule. The flash
    block rule budgets the TPU's 96 MiB of VMEM; it is kept unchanged,
    since here it only sets ``flash_torch``'s block sizes."""
    bax = batch_axes(mesh)
    shape_of = sharding.mesh_shape(mesh)
    act_spec = None
    qkv_spec = None
    if mapping == "fsdp_cp" and shape.kind == "train":
        # no tensor parallelism: batch over (pod, data), sequence over
        # `model` (context parallelism), weights fully sharded
        act_spec = P(bax, "model", None)
        qkv_spec = P(bax, "model", None, None)
        return ModelOptions(dtype=torch.bfloat16, attn_impl="auto",
                            remat=True, act_spec=act_spec,
                            qkv_spec=qkv_spec, kv_spec=qkv_spec)
    if shape.kind == "train" and not baseline:
        # Megatron-SP: the residual stream's sequence over `model`
        # between layers
        if shape.seq_len % shape_of["model"] == 0:
            act_spec = P(bax, "model", None)
        # attention computes with heads over `model`
        qkv_spec = P(bax, None, "model", None)
    elif shape.kind == "prefill" and not baseline:
        # serving: batch over data, heads over model
        act_spec = P(bax, None, None)
        qkv_spec = P(bax, None, "model", None)
    kv_spec = qkv_spec
    if (qkv_spec is not None and cfg.n_kv_heads
            and cfg.n_kv_heads % shape_of["model"]):
        kv_spec = P(bax, None, None, None)   # KV heads replicated in TP
    # explicit expert parallelism: all-to-all dispatch
    moe_impl, ep_axis, dp_axes = "gather", None, None
    if (cfg.moe is not None and not baseline
            and shape.kind in ("train", "prefill")
            and cfg.moe.n_experts % shape_of["model"] == 0):
        moe_impl, ep_axis, dp_axes = "ep_a2a", "model", bax
    # flash blocks: the per-step score tile (B_loc, H_loc, bq, bkv) f32
    # inside the TPU's VMEM
    block_q, block_kv = 512, 1024
    if cfg.n_heads and not baseline:
        dp_shards = int(np.prod([shape_of[a] for a in bax]))
        b_loc = max(1, shape.global_batch // dp_shards)
        h_loc = max(1, cfg.n_heads // shape_of["model"])
        budget = 96 * 2 ** 20 / 4 / b_loc / h_loc     # f32 elems for bq*bkv
        while block_q * block_kv > budget and block_q > 128:
            block_q //= 2
            if block_q * block_kv > budget and block_kv > 256:
                block_kv //= 2
    return ModelOptions(dtype=torch.bfloat16, attn_impl="auto",
                        remat=(shape.kind == "train"), act_spec=act_spec,
                        qkv_spec=qkv_spec, kv_spec=kv_spec,
                        moe_impl=moe_impl, ep_axis=ep_axis,
                        dp_axes=dp_axes, block_q=block_q,
                        block_kv=block_kv)


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of ``n`` ranks, this process ``rank``, for
    the block (PyTorch's ``fake`` backend: collectives complete at once
    and move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _forget_meshes():
    """Clear DTensor's caches of sharding plans: they hold the meshes of
    an earlier world, which compare equal to a new world's meshes of the
    same shape, and a cached plan's collectives would run on the old
    mesh's process groups — by name, which a world traced on another
    rank gives to other groups."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for cache in (getattr(_redistribute, "_gen_transform_infos", None),
                  getattr(prop, "propagate_op_sharding", None),
                  getattr(prop, "_propagate_tensor_meta_cached", None)):
        getattr(cache, "cache_clear", lambda: None)()
    getattr(_redistribute, "clear_redistribute_planner_cache",
            lambda: None)()
    # the C++ dispatch's own cache of the same plans (torch >= 2.12)
    getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
            lambda: None)()


def traced_rank(shape, mapping: str) -> int:
    """The rank a cell is traced on: under ``--mapping fsdp_cp`` a
    train cell's causal attention over a sequence split along ``model``
    gives each rank's queries the keys before them, so the last
    ``model`` coordinate does the most work and bounds the step — rank
    15 on both production meshes (``model``, 16 ranks, the innermost
    axis; the other coordinates 0); elsewhere every rank does the same
    work and rank 0 is traced."""
    return 15 if mapping == "fsdp_cp" and shape.kind == "train" else 0


def fsdp_axes(cfg, shape, mesh, baseline: bool, mapping: str):
    """``(fsdp_axes, model_axis)`` of a cell: FSDP over ``data`` for
    every train cell and for serving past 6 GB of TP-sharded weights."""
    if mapping == "fsdp_cp" and shape.kind == "train":
        return ("data", "model"), "__no_tp__"
    if not baseline and (shape.kind == "train" or cfg.n_params() * 2
                         / sharding.mesh_shape(mesh)["model"] > 6e9):
        return "data", "model"
    return None, "model"


def trace_step(cfg, shape, opts, mesh, fsdp=None, model_axis="model",
               zero1: bool = True, device=DEFAULT_DEVICE) -> tuple:
    """Trace one train, prefill or serve step of ``cfg`` at ``shape`` on
    ``mesh`` (``None``: plain tensors, no mesh). Returns (the
    :func:`~repro_torch.core.roofline.trace_stats` dict, the counter
    with its records, the peak bytes per device, the bytes of the
    step's arguments)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    dev = resolve_device(device)
    counter = roofline.TraceCounter(mesh)
    api = build_model(cfg, opts)
    with counter:
        params = api.init(torch.Generator(dev).manual_seed(0), dev)
        batch = make_batch(cfg, shape, torch.Generator(dev).manual_seed(1),
                           dev, opts)
        state = optlib.init(params) if shape.kind == "train" else None
        if shape.kind == "train":
            step = make_train_step(cfg, opts, TrainConfig(),
                                   grad_specs=None)
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg, opts)
        else:
            step = make_serve_step(cfg, opts)
        if mesh is not None:
            bax = batch_axes(mesh)
            pspecs = sharding.param_specs(params, mesh,
                                          model_axis=model_axis,
                                          fsdp_axes=fsdp)
            params = sharding.distribute_tree(params, pspecs, mesh)
            if shape.kind == "train":
                ospecs = optlib.state_specs(pspecs)
                if zero1:
                    ospecs = sharding.zero1_specs(state, ospecs, mesh)
                state = sharding.distribute_tree(state, ospecs, mesh)
                step = make_train_step(cfg, opts, TrainConfig(),
                                       grad_specs=pspecs)
            if shape.is_decode:
                batch = {
                    "cache": sharding.distribute_tree(
                        batch["cache"], sharding.cache_specs(
                            batch["cache"], mesh, bax, seq_axis="data"),
                        mesh),
                    "batch": sharding.distribute_tree(
                        batch["batch"], sharding.batch_specs(
                            batch["batch"], mesh, bax), mesh)}
            else:
                batch = sharding.distribute_tree(
                    batch, sharding.batch_specs(batch, mesh, bax), mesh)
        if shape.kind == "train":
            args = (params, state, batch)
        elif shape.kind == "prefill":
            args = (params, batch)
        else:
            args = (params, batch["cache"], batch["batch"])
        argument_bytes = sum(sharding.local(t).numel()
                             * sharding.local(t).element_size()
                             for t in leaves(args))
        tracker = MemTracker()
        tracker.track_external(*leaves(args))
        scope = (sharding.use_mesh(mesh) if mesh is not None
                 else contextlib.nullcontext())
        with tracker, scope:
            stats = roofline.trace_stats(step, *args)
        peak = sum(float(v["Total"]) for v in
                   tracker.get_tracker_snapshot("peak").values())
    return stats, counter, peak, argument_bytes


def cell_config(arch: str, smoke: bool = False, layers=None):
    """The config of ``arch``: reduced by ``smoke_config``, and/or cut
    to ``layers`` layers (for a hybrid, a multiple of its period);
    widths kept."""
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               baseline: bool = False, mapping: str = "tp_sp",
               device=DEFAULT_DEVICE, smoke: bool = False, layers=None):
    """Trace one cell on its production mesh over a fake process group;
    returns (report, memory: a dict of the peak and argument bytes per
    device). ``smoke`` and ``layers`` as :func:`cell_config`."""
    cfg = cell_config(arch, smoke, layers)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips, traced_rank(shape, mapping)):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        opts = model_options(cfg, shape, mesh, baseline, mapping)
        fsdp, model_axis = fsdp_axes(cfg, shape, mesh, baseline, mapping)
        stats, counter, peak, arg_bytes = trace_step(
            cfg, shape, opts, mesh, fsdp, model_axis, zero1=not baseline,
            device=device)
        pod = counter.traffic_by_axis().get("pod", 0.0)

    tokens = shape.global_batch * shape.seq_len
    if shape.is_decode:
        tokens = shape.global_batch          # one new token per sequence
    mf = model_flops_per_token(cfg) * tokens
    if shape.kind != "train":
        mf /= 3.0                             # fwd only = 2ND; 6ND has bwd

    rep = roofline.analyze_trace(arch, shape_name, mesh_name, n_chips,
                                 stats, mf, H100, dcn_traffic=pod,
                                 peak_bytes=peak)
    return rep, {"peak_bytes_per_device": peak, "argument_bytes": arg_bytes}


def run(archs, shapes, pods, out=None, baseline=False, verbose=True,
        mapping="tp_sp", device=DEFAULT_DEVICE, smoke=False, layers=None):
    rows = [roofline.HEADER]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        valid = {s.name for s in arch_shapes(cfg)}
        for shape_name in shapes:
            if shape_name not in valid:
                continue
            for multi_pod in pods:
                tag = f"{arch}/{shape_name}/{'2x16x16' if multi_pod else '16x16'}"
                t0 = time.time()
                try:
                    rep, mem = lower_cell(arch, shape_name, multi_pod,
                                          baseline, mapping, device, smoke,
                                          layers)
                    rows.append(rep.row())
                    if verbose:
                        print(f"[ok] {tag}: trace {time.time()-t0:.1f}s "
                              f"dominant={rep.dominant} "
                              f"t=({rep.t_compute*1e3:.2f},"
                              f"{rep.t_memory*1e3:.2f},"
                              f"{rep.t_collective*1e3:.2f})ms "
                              f"frac={rep.roofline_fraction:.2f}")
                        print(f"     memory: peak "
                              f"{mem['peak_bytes_per_device']:.3e} B, "
                              f"arguments {mem['argument_bytes']:.3e} B")
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}")
                    if verbose:
                        traceback.print_exc()
    if out:
        with open(out, "w") as f:
            f.write("\n".join(rows) + "\n")
        print(f"wrote {out}")
    return rows, failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful baseline (no beyond-paper opts)")
    ap.add_argument("--mapping", default="tp_sp",
                    choices=["tp_sp", "fsdp_cp"],
                    help="parallelism mapping (fsdp_cp: no TP, context "
                         "parallelism, ZeRO-3 over data x model)")
    ap.add_argument("--out", default=None)
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke_config (quick checks)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every model to this many layers, widths "
                         "kept (the trace time grows with the depth)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the device the fake tensors name (default "
                         "cuda, which must exist; cpu needs no card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    archs = [args.arch] if args.arch else list(list_archs(assigned_only=True))
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"both": [False, True], "single": [False],
            "multi": [True]}[args.multi_pod]
    _, failures = run(archs, shapes, pods, args.out, args.baseline,
                      verbose=not args.quiet, mapping=args.mapping,
                      device=args.device, smoke=args.smoke,
                      layers=args.layers)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        sys.exit(1)
    print("\nall cells traced OK")


if __name__ == "__main__":
    main()
