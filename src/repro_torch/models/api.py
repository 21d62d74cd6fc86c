"""Unified model API: one entry point per architecture family.

``build_model(cfg, opts)`` returns a ``ModelAPI`` with functional
``init / forward / loss / init_cache / decode_step`` members, used by
the train and serve steps and the smoke run alike.

``input_specs(cfg, shape)`` returns :class:`TensorSpec` stand-ins (shape
and dtype) for every model input of that (arch x shape) cell, without
allocating: the decode cache's are read off a cache built on the
``meta`` device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.layers import DEFAULT_OPTIONS, ModelOptions

# VLM stub: number of precomputed patch-embedding positions
N_PATCHES = 1024


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the port's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    opts: ModelOptions
    init: Callable[..., Any]
    forward: Callable[..., torch.Tensor]
    loss: Callable[..., torch.Tensor]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]


def build_model(cfg: ArchConfig,
                opts: ModelOptions = DEFAULT_OPTIONS) -> ModelAPI:
    """The model of ``cfg``: :mod:`~repro_torch.models.encdec` for an
    encoder-decoder, :mod:`~repro_torch.models.lm` for every other
    family."""
    if cfg.enc_dec:
        def init_cache(batch: int, max_seq: int, device=DEFAULT_DEVICE):
            return encdec.init_cache(cfg, batch, max_seq,
                                     enc_frames=max(max_seq // 2, 8),
                                     opts=opts, device=device)
        return ModelAPI(
            cfg=cfg, opts=opts,
            init=lambda generator, device=DEFAULT_DEVICE:
                encdec.init_params(cfg, generator, device, opts),
            forward=lambda p, b: encdec.forward(cfg, p, b, opts),
            loss=lambda p, b: encdec.loss_fn(cfg, p, b, opts),
            init_cache=init_cache,
            decode_step=lambda p, c, b: encdec.decode_step(cfg, p, c, b,
                                                           opts),
        )
    return ModelAPI(
        cfg=cfg, opts=opts,
        init=lambda generator, device=DEFAULT_DEVICE: lm.init_params(
            cfg, generator, device, opts),
        forward=lambda p, b: lm.forward(cfg, p, b, opts),
        loss=lambda p, b: lm.loss_fn(cfg, p, b, opts),
        init_cache=lambda batch, max_seq, device=DEFAULT_DEVICE:
            lm.init_cache(cfg, batch, max_seq, opts, device),
        decode_step=lambda p, c, b: lm.decode_step(cfg, p, c, b, opts),
    )


# --------------------------------------------------------------------------
# input specs (shape stand-ins) and concrete batches (smoke runs)
# --------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                opts: ModelOptions = DEFAULT_OPTIONS) -> Dict[str, Any]:
    """TensorSpecs for the *batch* argument of train/prefill steps, or
    the (cache, batch) pair for decode steps."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        train = shape.kind == "train"
        if cfg.enc_dec:
            half = s // 2
            batch = {"tokens": TensorSpec((b, half), torch.int32)}
            if train:
                batch["labels"] = TensorSpec((b, half), torch.int32)
            if cfg.audio_stub:
                batch["frame_embeds"] = TensorSpec((b, half, cfg.d_model),
                                                   opts.dtype)
            else:
                batch["tokens_enc"] = TensorSpec((b, half), torch.int32)
            return batch
        if cfg.vision_stub:
            n_patches = min(N_PATCHES, s // 2)
            n_txt = s - n_patches
            batch = {"patch_embeds": TensorSpec((b, n_patches, cfg.d_model),
                                                opts.dtype),
                     "tokens": TensorSpec((b, n_txt), torch.int32)}
            if train:
                batch["labels"] = TensorSpec((b, n_txt), torch.int32)
            return batch
        batch = {"tokens": TensorSpec((b, s), torch.int32)}
        if train:
            batch["labels"] = TensorSpec((b, s), torch.int32)
        return batch

    # decode: cache specs + one-token batch
    cache = specs_of(build_model(cfg, opts).init_cache(b, s,
                                                       device="meta"))
    return {"cache": cache,
            "batch": {"tokens": TensorSpec((b, 1), torch.int32)}}


def specs_of(tree):
    """A tree of tensors (dicts, SSMCaches) as :class:`TensorSpec`s."""
    if isinstance(tree, dict):
        return {k: specs_of(v) for k, v in tree.items()}
    if isinstance(tree, tuple):             # an SSMCache
        return type(tree)(*(specs_of(v) for v in tree))
    return TensorSpec(tuple(tree.shape), tree.dtype)


def scenario_shape(scenario, global_batch: int, seq: int) -> ShapeConfig:
    """Bridge from the simulator's :class:`repro_torch.core.scenario.
    Scenario` to the model-level ShapeConfig: the scenario kind picks the
    input contract (decode = one-token step over a KV cache of
    ``scenario.kv_len(seq)`` positions), so the simulated event graph
    and the executable model agree on shapes by construction."""
    kind = scenario.kind if scenario.kind in ("train", "prefill",
                                              "decode") else "train"
    s = scenario.kv_len(seq) if kind == "decode" else seq
    return ShapeConfig(name=f"{scenario.label()}_{s}", seq_len=s,
                       global_batch=global_batch, kind=kind)


def scenario_input_specs(cfg: ArchConfig, scenario, global_batch: int,
                         seq: int,
                         opts: ModelOptions = DEFAULT_OPTIONS
                         ) -> Dict[str, Any]:
    """``input_specs`` for a simulator scenario (see
    :func:`scenario_shape`)."""
    return input_specs(cfg, scenario_shape(scenario, global_batch, seq),
                       opts)


def make_batch(cfg: ArchConfig, shape: ShapeConfig,
               generator: torch.Generator, device=DEFAULT_DEVICE,
               opts: ModelOptions = DEFAULT_OPTIONS) -> Dict[str, Any]:
    """Concrete random batch matching input_specs, drawn on ``device``
    from ``generator``: integers uniform in [0, min(vocab, 32000)),
    floats standard normal — every leaf, the decode cache's included,
    as the reference does."""
    dev = resolve_device(device)
    high = min(cfg.vocab, 32000)

    def realize(spec):
        if isinstance(spec, dict):
            return {k: realize(v) for k, v in spec.items()}
        if not isinstance(spec, TensorSpec):     # an SSMCache of specs
            return type(spec)(*(realize(v) for v in spec))
        if spec.dtype.is_floating_point:
            return torch.randn(spec.shape, generator=generator,
                               device=dev).to(spec.dtype)
        return torch.randint(0, high, spec.shape, generator=generator,
                             device=dev, dtype=spec.dtype)

    return realize(input_specs(cfg, shape, opts))
