"""Encoder-decoder assembly in PyTorch (whisper-tiny backbone, T5): the
port of the reference package's ``repro.models.encdec``.

Encoder: bidirectional self-attention blocks. Decoder: causal
self-attention + cross-attention + FFN. ``n_layers`` means n encoder
AND n decoder layers. Positional encoding is RoPE for both stacks (the
modality frontend is a stub: the audio model reads ``frame_embeds``).
Under ``attn_impl="cuda"`` every attention of the prefill goes through
kernel K2: bidirectional in the encoder, causal in the decoder, and the
cross-attention with Sq (decoder tokens) ≠ Sk (encoder positions).

Decode caches: ring-buffer self-attention KV + precomputed cross K/V,
the self-attention KV updated in place (as :func:`repro_torch.models.lm.
decode_step` does).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import DEFAULT_OPTIONS, ModelOptions
from repro_torch.models.lm import (EMPTY_POS, _attn_block,
                                   _attn_decode_block, _attn_shapes,
                                   _chunked_ce, _ffn_block, _ffn_shapes,
                                   _head, _init_tree, _kv_cache,
                                   run_layer, unstack_layers)


def encdec_param_shapes(cfg: ArchConfig):
    enc = {**_attn_shapes(cfg), "ffn": _ffn_shapes(cfg)}
    dec = {**_attn_shapes(cfg), "cross": _attn_shapes(cfg),
           "ffn": _ffn_shapes(cfg)}
    return enc, dec


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=DEFAULT_DEVICE, opts: ModelOptions = DEFAULT_OPTIONS):
    """Random parameters of the reference's distribution (not its bits),
    drawn on ``device`` from ``generator``."""
    dev = resolve_device(device)
    dtype = opts.dtype
    enc_sh, dec_sh = encdec_param_shapes(cfg)

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=dev)
                * 0.02).to(dtype)

    params = {
        "embed": normal((cfg.vocab, cfg.d_model)),
        "enc_layers": _init_tree(generator, enc_sh, (cfg.n_layers,), dtype,
                                 dev),
        "dec_layers": _init_tree(generator, dec_sh, (cfg.n_layers,), dtype,
                                 dev),
        "enc_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.vocab))
    return params


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _enc_layer(cfg, lp, h, positions, opts):
    h = _attn_block(cfg, {k: v for k, v in lp.items() if k != "ffn"},
                    h, positions, opts, causal=False)
    h, _ = _ffn_block(cfg, lp["ffn"], h, opts)
    return L.constrain(h, opts)


def encode(cfg: ArchConfig, params, enc_x: torch.Tensor,
           opts: ModelOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """enc_x: (B,F,d) stub embeddings (audio) or embedded tokens."""
    b, f = enc_x.shape[:2]
    positions = _positions(b, f, enc_x.device)
    h = enc_x
    for lp in unstack_layers(params["enc_layers"], cfg.n_layers):
        h = run_layer(opts, _enc_layer, cfg, lp, h, positions, opts)
    return L.rmsnorm(h, params["enc_norm"])


def _dec_layer(cfg, lp, h, positions, enc_out, enc_pos, opts):
    h = _attn_block(cfg, {k: v for k, v in lp.items()
                          if k not in ("ffn", "cross")},
                    h, positions, opts, causal=True)
    h = _attn_block(cfg, lp["cross"], h, positions, opts, causal=False,
                    kv=(enc_out, enc_pos))
    h, _ = _ffn_block(cfg, lp["ffn"], h, opts)
    return L.constrain(h, opts)


def decode_train(cfg: ArchConfig, params, enc_out: torch.Tensor,
                 tokens: torch.Tensor,
                 opts: ModelOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Teacher-forced decoder forward → hidden (B,T,d)."""
    b, t = tokens.shape
    positions = _positions(b, t, tokens.device)
    enc_pos = _positions(b, enc_out.shape[1], tokens.device)
    h = params["embed"][tokens.long()].to(opts.dtype)
    for lp in unstack_layers(params["dec_layers"], cfg.n_layers):
        h = run_layer(opts, _dec_layer, cfg, lp, h, positions, enc_out,
                      enc_pos, opts)
    return h


def _encoder_input(cfg, params, batch, opts):
    if cfg.audio_stub:
        return batch["frame_embeds"].to(opts.dtype)
    return params["embed"][batch["tokens_enc"].long()].to(opts.dtype)


@torch.no_grad()
def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Encoder, then the teacher-forced decoder, to logits (B,T,V)."""
    enc_out = encode(cfg, params, _encoder_input(cfg, params, batch, opts),
                     opts)
    h = decode_train(cfg, params, enc_out, batch["tokens"], opts)
    h = L.rmsnorm(h, params["final_norm"])
    return h @ _head(cfg, params)


def loss_fn(cfg: ArchConfig, params, batch, opts=DEFAULT_OPTIONS):
    """Chunked cross-entropy of the decoder's labels (no aux loss)."""
    enc_out = encode(cfg, params, _encoder_input(cfg, params, batch, opts),
                     opts)
    h = decode_train(cfg, params, enc_out, batch["tokens"], opts)
    h = L.rmsnorm(h, params["final_norm"])
    return _chunked_ce(h, _head(cfg, params), batch["labels"])


# --------------------------------------------------------------------------
# decode (serve)
# --------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, enc_frames: int,
               opts: ModelOptions = DEFAULT_OPTIONS, device=DEFAULT_DEVICE):
    """Zeros: a ``max_seq``-slot self-attention ring buffer per decoder
    layer (kpos 2**30 marks empty slots) and ``enc_frames`` positions of
    cross K/V, which :func:`precompute_cross` fills."""
    dev = resolve_device(device)
    hd, kh, n = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "self": _kv_cache(cfg, n, batch, max_seq, opts.dtype, dev),
        "cross_k": torch.zeros((n, batch, enc_frames, kh, hd),
                               dtype=opts.dtype, device=dev),
        "cross_v": torch.zeros((n, batch, enc_frames, kh, hd),
                               dtype=opts.dtype, device=dev),
    }


@torch.no_grad()
def precompute_cross(cfg: ArchConfig, params, enc_out: torch.Tensor):
    """Cross K/V of every decoder layer from an encoder pass (serve-time
    prefill): a pair of (n_layers, B, F, KH, hd) tensors."""
    ks, vs = [], []
    b, f = enc_out.shape[:2]
    for lp in unstack_layers(params["dec_layers"], cfg.n_layers):
        cp = lp["cross"]
        k, v = enc_out @ cp["wk"], enc_out @ cp["wv"]
        if cfg.qkv_bias:
            k, v = k + cp["bk"], v + cp["bv"]
        ks.append(k.reshape(b, f, cfg.n_kv_heads, cfg.head_dim))
        vs.append(v.reshape(b, f, cfg.n_kv_heads, cfg.head_dim))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, batch,
                opts: ModelOptions = DEFAULT_OPTIONS):
    """One-token decode: causal self-attention over the ring buffer
    (updated IN PLACE), cross-attention over the cached encoder K/V, the
    FFN. Returns (logits (B,V), cache with ``pos + 1``)."""
    tok = batch["tokens"]
    x = params["embed"][tok.long()].to(opts.dtype)
    pos = cache["pos"]
    b = tok.shape[0]
    hd = cfg.head_dim
    f = cache["cross_k"].shape[2]
    enc_pos = _positions(b, f, x.device)
    # every encoder position is visible from the decoder (2**29 >= all)
    cross_qpos = torch.full((b, 1), EMPTY_POS // 2, dtype=torch.int32,
                            device=x.device)
    selfc = cache["self"]
    for i, lp in enumerate(unstack_layers(params["dec_layers"],
                                          cfg.n_layers)):
        p = {k: v for k, v in lp.items() if k not in ("ffn", "cross")}
        x = _attn_decode_block(cfg, p, x, pos,
                               {name: t[i] for name, t in selfc.items()})
        cp = lp["cross"]
        hn = L.rmsnorm(x, cp["ln"])
        q = hn @ cp["wq"]
        if cfg.qkv_bias:
            q = q + cp["bq"]
        q = q.reshape(b, 1, cfg.n_heads, hd)
        o = L.attention_decode(q, cache["cross_k"][i], cache["cross_v"][i],
                               cross_qpos, enc_pos)
        x = x + o.reshape(b, 1, cfg.n_heads * hd) @ cp["wo"]
        x, _ = _ffn_block(cfg, lp["ffn"], x, opts)
    x = L.rmsnorm(x, params["final_norm"])
    return (x @ _head(cfg, params))[:, 0], {**cache, "pos": pos + 1}
