"""End-to-end training loop: model + AdamW + data + checkpoint/restart
+ heartbeat monitoring — the reference package's
``repro.train.train_loop`` on a torch device.

``fit`` runs on ``device``, the card by default; without one it raises
(``core.device.resolve_device``), and it runs on the CPU only when the
caller passes ``device="cpu"``. Parameters are drawn from a
``torch.Generator`` on that device seeded with ``loop.seed``. A step's
time is taken on the host around the step and ``loss.item()``, which
waits for the device, as the reference's ``float(metrics["loss"])``
does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.models.api import build_model
from repro_torch.models.layers import ModelOptions
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.fault_tolerance import HeartbeatMonitor
from repro_torch.train.step import TrainConfig, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    log_every: int = 10
    save_every: int = 0              # 0 = no checkpointing
    ckpt_dir: Optional[str] = None
    seed: int = 0
    resume: bool = True


@dataclasses.dataclass
class FitResult:
    losses: List[float]
    steps_done: int
    resumed_from: Optional[int]
    step_times: List[float]
    grad_norms: List[float]


def fit(cfg: ArchConfig, opts: ModelOptions = None,
        tcfg: TrainConfig = None, loop: LoopConfig = LoopConfig(),
        verbose: bool = True, device=DEFAULT_DEVICE) -> FitResult:
    dev = resolve_device(device)
    opts = opts or ModelOptions(dtype=torch.float32, remat=False)
    tcfg = tcfg or TrainConfig(adamw=opt.AdamWConfig(
        lr=1e-3, warmup_steps=max(10, loop.steps // 20),
        total_steps=loop.steps))
    api = build_model(cfg, opts)
    params = api.init(torch.Generator(dev).manual_seed(loop.seed), dev)
    state = opt.init(params)

    resumed_from = None
    start_step = 0
    if loop.ckpt_dir and loop.resume and ckpt.latest_step(loop.ckpt_dir) \
            is not None:
        (params, state), start_step = ckpt.restore(
            loop.ckpt_dir, (params, state))
        resumed_from = start_step

    step_fn = make_train_step(cfg, opts, tcfg)
    dcfg = DataConfig(seed=loop.seed, vocab=cfg.vocab,
                      seq_len=loop.seq_len, global_batch=loop.global_batch)
    loader = DataLoader(dcfg, start_step=start_step, arch=cfg)
    monitor = HeartbeatMonitor(n_workers=1)

    losses: List[float] = []
    times: List[float] = []
    norms: List[float] = []
    try:
        for step, batch in loader:
            if step >= loop.steps:
                break
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch)
            loss = metrics["loss"].item()
            dt = time.perf_counter() - t0
            monitor.heartbeat(0, dt)
            losses.append(loss)
            times.append(dt)
            norms.append(metrics["grad_norm"].item())
            if verbose and (step % loop.log_every == 0
                            or step == loop.steps - 1):
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"lr {metrics['lr'].item():.2e} "
                      f"gnorm {norms[-1]:8.3f} "
                      f"{dt*1e3:7.1f} ms")
            if loop.save_every and loop.ckpt_dir \
                    and (step + 1) % loop.save_every == 0:
                ckpt.save(loop.ckpt_dir, step + 1, (params, state))
    finally:
        loader.close()
    return FitResult(losses=losses, steps_done=len(losses) + start_step,
                     resumed_from=resumed_from, step_times=times,
                     grad_norms=norms)
