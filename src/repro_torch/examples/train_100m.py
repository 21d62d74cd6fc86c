"""End-to-end training script: ~100M-parameter decoder LM on ``--device``.

Full substrate in play: synthetic data pipeline with prefetch, AdamW with
warmup+cosine, per-layer remat off, checkpoint/restart every 50 steps,
heartbeat monitoring. Resume after interruption just re-runs the same
command.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 20 \\
        --tiny --device cpu  # CI
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.models.layers import ModelOptions
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainConfig
from repro_torch.train.train_loop import LoopConfig, fit


def model_100m() -> ArchConfig:
    """~101M params: 12L d=768 12H d_ff=2048 vocab=32k (GPT-2-small-ish
    with SwiGLU)."""
    return ArchConfig(name="lm_100m", family="dense", n_layers=12,
                      d_model=768, n_heads=12, n_kv_heads=12, d_ff=2048,
                      vocab=32000, tie_embeddings=True)


def model_tiny() -> ArchConfig:
    return dataclasses.replace(model_100m(), name="lm_tiny", n_layers=2,
                               d_model=128, n_heads=4, n_kv_heads=4,
                               d_ff=512, vocab=2048)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_100m"))
    ap.add_argument("--tiny", action="store_true",
                    help="2L/128d config for smoke runs")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = model_tiny() if args.tiny else model_100m()
    print(f"model: {cfg.name}  params={cfg.n_params()/1e6:.1f}M")

    tcfg = TrainConfig(adamw=AdamWConfig(
        lr=args.lr, warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps))
    res = fit(cfg,
              opts=ModelOptions(dtype=torch.float32, remat=False),
              tcfg=tcfg,
              loop=LoopConfig(steps=args.steps, seq_len=args.seq,
                              global_batch=args.batch, log_every=10,
                              save_every=50, ckpt_dir=args.ckpt_dir),
              device=args.device)
    print(f"\ndone: {res.steps_done} steps "
          f"(resumed from {res.resumed_from})")
    print(f"loss: {res.losses[0]:.4f} → {res.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
