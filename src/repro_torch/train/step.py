"""Serve step factories: the prefill (full forward to logits) and the
one-token decode step of a model. ``make_train_step`` comes with the
optimizer (ROADMAP.md, Queue 1)."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import build_model
from repro_torch.models.layers import DEFAULT_OPTIONS, ModelOptions


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
