"""AdamW in PyTorch, as the reference package's ``repro.train.optimizer``
computes it: fp32 moments, a global-norm clip, linear warmup then cosine
decay, and each parameter updated in fp32 and cast back to its own
dtype (no master copy).

State layout mirrors the parameter tree (two moment trees + step). The
update is functional: it returns new parameters and a new state and
changes neither argument. :func:`state_specs` gives the state's
sharding specs from the parameters' (ZeRO-1 adds ``data`` to the moments
through :func:`repro_torch.parallel.sharding.zero1_specs`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import telemetry
from repro_torch.parallel.sharding import P
from repro_torch.train.tree import leaves, map_leaves, unflatten_like


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar, on the parameters' device
    mu: Any
    nu: Any


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac, in fp32."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params: Any) -> AdamWState:
    """Zero moments in fp32 beside each parameter, step 0."""
    first = leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=map_leaves(zeros, params), nu=map_leaves(zeros, params))


def state_specs(pspecs: Any) -> AdamWState:
    """Sharding specs for AdamWState given the parameter specs."""
    return AdamWState(step=P(), mu=pspecs, nu=pspecs)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, summed leaf by
    leaf in pytree order as the reference sums."""
    total = 0
    for x in leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def update(cfg: AdamWConfig, params: Any, grads: Any,
           state: AdamWState) -> tuple:
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    with telemetry.span("optimizer.update"):
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = lr_schedule(cfg, state.step)
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()

        def upd(p, g, m, v):
            g = g.float() * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g.square()
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            delta = delta + cfg.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        cols = [leaves(t) for t in (params, grads, state.mu, state.nu)]
        if any(len(c) != len(cols[0]) for c in cols):
            raise ValueError("params, grads and moments differ in structure")
        new = [upd(*x) for x in zip(*cols)]
        new_p, new_m, new_v = (unflatten_like(params, [n[i] for n in new])
                               for i in range(3))
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_p, AdamWState(step=step, mu=new_m, nu=new_v), metrics
