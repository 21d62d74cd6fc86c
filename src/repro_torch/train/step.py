"""Train/serve step factories: the functions the trainer and the server
call.

``make_train_step`` returns a full production step: loss → gradients
(optionally accumulated over microbatches) → global-norm clip → AdamW
update. ``make_prefill_step`` returns the full forward to logits and
``make_serve_step`` the one-token decode step.

Parameters may be DTensors (:mod:`repro_torch.parallel.sharding`). The
model makes plain tensors mid-flight (positions, masks, the aux loss's
zero), so a step over DTensors runs under DTensor's
``implicit_replication``, which takes each of them as replicated; its
metrics come back as plain tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import build_model
from repro_torch.models.layers import DEFAULT_OPTIONS, ModelOptions
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import leaves, map_leaves, unflatten_like


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    accum_steps: int = 1              # gradient-accumulation microbatches


def value_and_grad(loss_fn: Callable, params: Any,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor,
                                                            Any]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the gradients a
    tree like ``params`` in each parameter's dtype. The caller's tensors
    are not marked as requiring grad; a parameter that the loss does not
    reach gets zeros, as under ``jax.value_and_grad``."""
    with torch.enable_grad():
        tree = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, leaves(tree), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten_like(params, grads)


def _over_dtensors(active: bool):
    """DTensor's ``implicit_replication`` where DTensors meet the plain
    tensors the model makes; nothing otherwise."""
    if not active:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _full(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if sharding.is_dtensor(x) else x


def make_train_step(cfg: ArchConfig, opts: ModelOptions = DEFAULT_OPTIONS,
                    tcfg: TrainConfig = TrainConfig(),
                    grad_specs: Optional[Any] = None) -> Callable:
    """The train step. ``grad_specs``: a :class:`~repro_torch.parallel.
    sharding.P` tree like the parameters'; the gradients are placed by it
    on the current mesh before the optimizer."""
    api = build_model(cfg, opts)

    def train_step(params, opt_state, batch):
        distributed = grad_specs is not None or any(
            sharding.is_dtensor(p) for p in leaves(params))
        with _over_dtensors(distributed):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if tcfg.accum_steps == 1:
            loss, grads = value_and_grad(api.loss, params, batch)
        else:
            # split the batch into microbatches along dim 0 and accumulate
            a = tcfg.accum_steps
            micro = [{k: v.reshape((a, v.shape[0] // a) + v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(a)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            grads = map_leaves(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for mb in micro:
                l, g = value_and_grad(api.loss, params, mb)
                loss = loss + l
                grads = map_leaves(torch.add, grads, g)
            loss = loss / a
            grads = map_leaves(lambda g: g / a, grads)
        if grad_specs is not None:
            # pin gradient sharding to the parameter sharding BEFORE the
            # optimizer. The reference also puts an optimization barrier
            # here, against XLA hoisting the optimizer's fp32 converts
            # above the gradient reduction; eager PyTorch runs the ops in
            # program order and has no such barrier or need of one.
            grads = sharding.distribute_tree(grads, grad_specs,
                                             sharding.current_mesh())
        new_params, new_state, metrics = opt.update(
            tcfg.adamw, params, grads, opt_state)
        metrics = {k: _full(v) for k, v in metrics.items()}
        return new_params, new_state, {"loss": _full(loss), **metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig,
                      opts: ModelOptions = DEFAULT_OPTIONS) -> Callable:
    api = build_model(cfg, opts)

    def prefill_step(params, batch):
        return api.forward(params, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig,
                    opts: ModelOptions = DEFAULT_OPTIONS) -> Callable:
    api = build_model(cfg, opts)

    def serve_step(params, cache, batch):
        return api.decode_step(params, cache, batch)

    return serve_step
