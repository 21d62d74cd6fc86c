"""Decoder-only LM assembly in PyTorch: the dense and VLM families of
the reference package's ``repro.models.lm``: forward, loss and decode.

Parameters are a nested dict of tensors with the reference's names and
layout: ``embed``, ``final_norm``, optional ``head``, and
``attn_layers`` — every per-layer weight STACKED over a leading layer
axis, the FFN nested under ``ffn``. A converted reference tree
(:mod:`repro_torch.models.convert`) is therefore used as it is. Layers
run in a Python loop over the stack, each stacked leaf unbound once per
call (so under autograd the stack's gradient is one ``stack``, not a
zero-filled stack per layer), and each layer is checkpointed under
``opts.remat`` as the reference's ``jax.checkpoint`` does.

Public entry points (used by api.py):
  init_params(cfg, generator, device, opts)      → parameter dict
  forward(cfg, params, batch, opts)              → logits (prefill)
  loss_fn(cfg, params, batch, opts)              → scalar loss (chunked CE)
  init_cache(cfg, batch, max_seq, opts, device)  → decode cache dict
  decode_step(cfg, params, cache, batch, opts)   → (logits, cache)

The families ``moe``, ``ssm``, hybrid and encoder-decoder raise
``NotImplementedError`` until their modules are ported (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import DEFAULT_OPTIONS, ModelOptions

Params = Dict[str, Any]

#: empty decode-cache slots carry this position (masked by causality)
EMPTY_POS = 2 ** 30


def check_family(cfg: ArchConfig) -> None:
    """Raise for the families whose modules are not ported yet."""
    if cfg.enc_dec:
        what = "encoder-decoder models (models/encdec.py)"
    elif cfg.family == "ssm":
        what = "the ssm family (models/ssm.py)"
    elif cfg.hybrid_period:
        what = "hybrid attention/SSM models (models/ssm.py, models/moe.py)"
    elif cfg.moe is not None:
        what = "the moe family (models/moe.py)"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what} is not ported yet; ROADMAP.md Queue 1 lists "
        f"it as the next item of the model path")


# --------------------------------------------------------------------------
# parameter construction
# --------------------------------------------------------------------------

def _attn_shapes(cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.head_dim
    sh = {
        "ln": (d,),
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qkv_bias:
        sh.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                  bv=(cfg.n_kv_heads * hd,))
    return sh


def _ffn_shapes(cfg: ArchConfig):
    d = cfg.d_model
    if cfg.mlp_gelu:
        return {"ln": (d,), "w1": (d, cfg.d_ff), "b1": (cfg.d_ff,),
                "w2": (cfg.d_ff, d), "b2": (d,)}
    return {"ln": (d,), "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d)}


def block_shapes(cfg: ArchConfig) -> Dict[str, Dict]:
    """Per-layer-kind parameter shape trees (unstacked)."""
    check_family(cfg)
    return {"attn": {**_attn_shapes(cfg), "ffn": _ffn_shapes(cfg)}}


def _init_tree(generator, shapes, n_layers, dtype, device):
    """One layer's weights drawn and copied over the stack, as the
    reference does: normal·0.02 for matrices, ones for norms, zeros for
    biases."""
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if isinstance(shape, dict):
            out[name] = _init_tree(generator, shape, n_layers, dtype, device)
            continue
        if name.startswith("ln"):
            leaf = torch.ones(shape, dtype=dtype, device=device)
        elif len(shape) == 1:
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        else:
            leaf = (torch.randn(shape, generator=generator, device=device)
                    * 0.02).to(dtype)
        out[name] = leaf.expand((n_layers, *shape)).clone()
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=DEFAULT_DEVICE,
                opts: ModelOptions = DEFAULT_OPTIONS) -> Params:
    """Random parameters of the reference's distribution (not its bits),
    drawn on ``device`` from ``generator`` (which must live there)."""
    check_family(cfg)
    dev = resolve_device(device)
    dtype = opts.dtype

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=dev)
                * 0.02).to(dtype)

    params: Params = {
        "embed": normal((cfg.vocab, cfg.d_model)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.vocab))
    params["attn_layers"] = _init_tree(generator, block_shapes(cfg)["attn"],
                                       cfg.n_layers, dtype, dev)
    return params


def unstack_layers(stacked: Params, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree (views, no copy),
    each leaf unbound once."""
    out = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = unstack_layers(v, n) if isinstance(v, dict) \
            else torch.unbind(v)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _head(cfg: ArchConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# --------------------------------------------------------------------------
# blocks (forward)
# --------------------------------------------------------------------------

def _qkv(cfg, p, h):
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _attn_block(cfg, p, x, positions, opts):
    """Pre-norm causal self-attention with residual."""
    h = L.rmsnorm(x, p["ln"])
    q, k, v = _qkv(cfg, p, h)
    b, s = q.shape[:2]
    hd = cfg.head_dim
    q = L.constrain_qkv(q.reshape(b, s, cfg.n_heads, hd), opts)
    k = L.constrain_qkv(k.reshape(b, s, cfg.n_kv_heads, hd), opts,
                        is_kv=True)
    v = L.constrain_qkv(v.reshape(b, s, cfg.n_kv_heads, hd), opts,
                        is_kv=True)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.attention(q, k, v, positions, positions, causal=True,
                    window=cfg.sliding_window, opts=opts)
    o = L.constrain_qkv(o, opts)
    o = o.reshape(b, s, cfg.n_heads * hd) @ p["wo"]
    return x + L.constrain(o, opts)


def _ffn_block(cfg, p, x, opts):
    h = L.rmsnorm(x, p["ln"])
    if "w1" in p:                           # GELU MLP
        y = L.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"])
    else:                                   # SwiGLU
        y = L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return x + L.constrain(y, opts)


def _attn_layer(cfg, p, x, positions, opts):
    pa = {k: v for k, v in p.items() if k != "ffn"}
    x = _attn_block(cfg, pa, x, positions, opts)
    return _ffn_block(cfg, p["ffn"], x, opts)


# --------------------------------------------------------------------------
# backbone forward (prefill)
# --------------------------------------------------------------------------

def backbone(cfg: ArchConfig, params: Params, x: torch.Tensor,
             positions: torch.Tensor, opts: ModelOptions) -> torch.Tensor:
    """The layer stack. x: (B,S,d) → (B,S,d). Under ``opts.remat`` and
    autograd each layer keeps only its input and recomputes the rest in
    the backward."""
    check_family(cfg)
    remat = opts.remat and torch.is_grad_enabled()
    for lp in unstack_layers(params["attn_layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_attn_layer, cfg, lp, x, positions, opts,
                           use_reentrant=False)
        else:
            x = _attn_layer(cfg, lp, x, positions, opts)
        x = L.constrain(x, opts)
    return x


def embed_inputs(cfg: ArchConfig, params: Params,
                 batch: Dict[str, torch.Tensor], opts: ModelOptions):
    """tokens (+ optional stub patch embeddings) → (B,S,d), positions."""
    parts = []
    if cfg.vision_stub and "patch_embeds" in batch:
        parts.append(batch["patch_embeds"].to(opts.dtype))
    if "tokens" in batch:
        parts.append(params["embed"][batch["tokens"].long()])
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


@torch.no_grad()
def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Full forward to logits (B,S,V)."""
    x, positions = embed_inputs(cfg, params, batch, opts)
    x = backbone(cfg, params, x, positions, opts)
    x = L.rmsnorm(x, params["final_norm"])
    return x @ _head(cfg, params)


def _chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over labels >= 0 without materializing (B,S,V):
    a loop over S chunks, labels padded with -1 to a whole chunk."""
    b, s, d = x.shape
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        ll = labels[:, c0:c0 + chunk].long()
        logits = (x[:, c0:c0 + chunk] @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll.clamp(min=0)[..., None])[..., 0]
        valid = ll >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp(min=1)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Scalar training loss: chunked cross-entropy of the next-token
    labels (-1 = no target), the stub modality prefix carrying none."""
    x, positions = embed_inputs(cfg, params, batch, opts)
    x = backbone(cfg, params, x, positions, opts)
    x = L.rmsnorm(x, params["final_norm"])
    labels = batch["labels"]
    if labels.shape[1] != x.shape[1]:       # stub modality prefix: no loss
        labels = F.pad(labels, (x.shape[1] - labels.shape[1], 0), value=-1)
    ce = _chunked_ce(x, _head(cfg, params), labels)
    aux = 0.0       # the MoE load-balance loss: 0 for the ported families
    return ce + 0.01 * aux


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------

def _kv_cache_len(cfg: ArchConfig, max_seq: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               opts: ModelOptions = DEFAULT_OPTIONS,
               device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Decode cache (zeros; kpos 2**30 marks empty slots): a ring buffer
    of ``min(sliding_window, max_seq)`` slots per layer."""
    check_family(cfg)
    dev = resolve_device(device)
    s = _kv_cache_len(cfg, max_seq)
    n, hd, kh = cfg.n_layers, cfg.head_dim, cfg.n_kv_heads
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "attn": {
            "k": torch.zeros((n, batch, s, kh, hd), dtype=opts.dtype,
                             device=dev),
            "v": torch.zeros((n, batch, s, kh, hd), dtype=opts.dtype,
                             device=dev),
            "kpos": torch.full((n, batch, s), EMPTY_POS, dtype=torch.int32,
                               device=dev),
        },
    }


def _attn_decode_block(cfg, p, x, pos, kcache):
    """x: (B,1,d); kcache: dict(k,v,kpos) of THIS layer, (B,S,KH,hd)
    views into the stacked cache, updated in place."""
    b = x.shape[0]
    h = L.rmsnorm(x, p["ln"])
    q, k, v = _qkv(cfg, p, h)
    hd = cfg.head_dim
    q = q.reshape(b, 1, cfg.n_heads, hd)
    k = k.reshape(b, 1, cfg.n_kv_heads, hd)
    v = v.reshape(b, 1, cfg.n_kv_heads, hd)
    qpos = pos[:, None]                                    # (B,1)
    q = L.apply_rope(q, qpos, cfg.rope_theta)
    k = L.apply_rope(k, qpos, cfg.rope_theta)

    s = kcache["k"].shape[1]
    slot = (pos % s).long()                                # ring buffer
    bi = torch.arange(b, device=x.device)
    kcache["k"][bi, slot] = k[:, 0]
    kcache["v"][bi, slot] = v[:, 0]
    kcache["kpos"][bi, slot] = pos

    o = L.attention_decode(q, kcache["k"], kcache["v"], qpos, kcache["kpos"],
                           window=cfg.sliding_window)
    o = o.reshape(b, 1, cfg.n_heads * hd) @ p["wo"]
    return x + o


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                batch: Dict[str, torch.Tensor],
                opts: ModelOptions = DEFAULT_OPTIONS):
    """One-token decode. batch: {tokens: (B,1)}. Returns (logits (B,V),
    cache). Unlike the reference, the KV tensors of ``cache`` are
    updated IN PLACE (one cache, not one per step); the returned dict
    shares them and carries ``pos + 1``."""
    check_family(cfg)
    x = params["embed"][batch["tokens"].long()].to(opts.dtype)   # (B,1,d)
    pos = cache["pos"]
    kv = cache["attn"]
    layers = unstack_layers(params["attn_layers"], cfg.n_layers)
    for i, lp in enumerate(layers):
        pa = {k: v for k, v in lp.items() if k != "ffn"}
        x = _attn_decode_block(cfg, pa, x, pos,
                               {name: t[i] for name, t in kv.items()})
        x = _ffn_block(cfg, lp["ffn"], x, opts)
    x = L.rmsnorm(x, params["final_norm"])
    logits = (x @ _head(cfg, params))[:, 0]
    return logits, {**cache, "pos": pos + 1}
