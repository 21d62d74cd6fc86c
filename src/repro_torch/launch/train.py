"""Training launcher CLI — the reference package's ``repro.launch.train``
on a torch device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \
        --smoke --steps 50 [--ckpt-dir /tmp/ckpt] [--device cpu]

``--smoke`` trains the reduced same-family config; without it the
config is full width. It trains on ``--device``, the card by default,
and raises without one; ``--device cpu`` runs the plain PyTorch path on
the host. fp32, no remat, as the reference's launcher.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config, list_archs, smoke_config
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.models.layers import ModelOptions
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainConfig
from repro_torch.train.train_loop import LoopConfig, fit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_1_5b",
                    choices=list(list_archs()))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"(active {cfg.n_active_params()/1e6:.1f}M)")

    res = fit(
        cfg,
        opts=ModelOptions(dtype=torch.float32, remat=False),
        tcfg=TrainConfig(
            adamw=AdamWConfig(lr=args.lr,
                              warmup_steps=max(10, args.steps // 20),
                              total_steps=args.steps),
            accum_steps=args.accum),
        loop=LoopConfig(steps=args.steps, seq_len=args.seq,
                        global_batch=args.batch, log_every=10,
                        save_every=args.save_every if args.ckpt_dir else 0,
                        ckpt_dir=args.ckpt_dir),
        device=args.device)
    print(f"done: loss {res.losses[0]:.4f} → {res.losses[-1]:.4f} "
          f"({res.steps_done} steps)")


if __name__ == "__main__":
    main()
