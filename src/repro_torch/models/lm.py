"""Decoder-only LM assembly in PyTorch: dense / GQA / SWA / MoE / SSM /
hybrid / VLM, the port of the reference package's ``repro.models.lm``:
forward, loss and decode.

Parameters are a nested dict of tensors with the reference's names and
layout: ``embed``, ``final_norm``, optional ``head``, and one stacked
tree per layer kind — ``attn_layers`` (the FFN nested under ``ffn``),
``ssm_layers``, and for the hybrid family ``ssm_moe_layers`` /
``ssm_dense_layers`` stacked over (period, layer of the period). Every
per-layer weight is STACKED over leading layer axes, so a converted
reference tree (:mod:`repro_torch.models.convert`) is used as it is.
Layers run in a Python loop over the stack, each stacked leaf unbound
once per call (so under autograd the stack's gradient is one ``stack``,
not a zero-filled stack per layer), and each layer (for the hybrid, each
period) is checkpointed under ``opts.remat`` as the reference's
``jax.checkpoint`` does.

Public entry points (used by api.py):
  init_params(cfg, generator, device, opts)      → parameter dict
  forward(cfg, params, batch, opts)              → logits (prefill)
  loss_fn(cfg, params, batch, opts)              → scalar loss (chunked CE
                                                   + 0.01 · MoE aux loss)
  init_cache(cfg, batch, max_seq, opts, device)  → decode cache dict
  decode_step(cfg, params, cache, batch, opts)   → (logits, cache)

The encoder-decoder family is :mod:`repro_torch.models.encdec`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import DEFAULT_OPTIONS, ModelOptions
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (gather_dim, gather_fsdp,
                                           is_dtensor, settle)

Params = Dict[str, Any]

#: empty decode-cache slots carry this position (masked by causality)
EMPTY_POS = 2 ** 30


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


def _ffn_shapes(cfg: ArchConfig, use_moe: bool = True):
    d = cfg.d_model
    if cfg.moe is not None and use_moe:
        return {"ln": (d,), **M.moe_params_shape(d, cfg.moe)}
    if cfg.mlp_gelu:
        return {"ln": (d,), "w1": (d, cfg.d_ff), "b1": (cfg.d_ff,),
                "w2": (cfg.d_ff, d), "b2": (d,)}
    return {"ln": (d,), "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d)}


def _ssm_shapes(cfg: ArchConfig):
    return {"ln": (cfg.d_model,), **S.ssm_params_shape(cfg.d_model, cfg.ssm)}


def hybrid_ssm_split(cfg: ArchConfig):
    """(n_ssm_moe, n_ssm_dense) per hybrid period.

    A period has `hybrid_period` layers: 1 attention (which takes the MoE
    FFN when the period offset is MoE-aligned — true for jamba) and the
    rest SSM. MoE hits every `moe_period`-th FFN.
    """
    per = cfg.hybrid_period
    n_ssm = per - 1
    if cfg.moe is None:
        return 0, n_ssm
    n_moe_total = per // cfg.moe_period
    n_ssm_moe = max(0, n_moe_total - 1)        # attn layer takes one MoE slot
    return n_ssm_moe, n_ssm - n_ssm_moe


def block_shapes(cfg: ArchConfig) -> Dict[str, Dict]:
    """Per-layer-kind parameter shape trees (unstacked)."""
    out = {}
    if cfg.family == "ssm":
        out["ssm"] = _ssm_shapes(cfg)
    elif cfg.hybrid_period:
        n_moe, n_dense = hybrid_ssm_split(cfg)
        out["attn"] = {**_attn_shapes(cfg), "ffn": _ffn_shapes(cfg)}
        if n_moe:
            out["ssm_moe"] = {**_ssm_shapes(cfg),
                              "ffn": _ffn_shapes(cfg, use_moe=True)}
        if n_dense:
            out["ssm_dense"] = {**_ssm_shapes(cfg),
                                "ffn": _ffn_shapes(cfg, use_moe=False)}
    else:
        out["attn"] = {**_attn_shapes(cfg), "ffn": _ffn_shapes(cfg)}
    return out


def _stack_counts(cfg: ArchConfig):
    """How many stacked copies of each block kind."""
    if cfg.family == "ssm":
        return {"ssm": (cfg.n_layers,)}
    if cfg.hybrid_period:
        n_per = cfg.n_layers // cfg.hybrid_period
        n_moe, n_dense = hybrid_ssm_split(cfg)
        out = {"attn": (n_per,)}
        if n_moe:
            out["ssm_moe"] = (n_per, n_moe)
        if n_dense:
            out["ssm_dense"] = (n_per, n_dense)
        return out
    return {"attn": (cfg.n_layers,)}


def _init_leaf(name, shape, generator, dtype, device):
    """One layer's leaf of the reference's distribution: ones for norms
    and ``D``, the SSM's ``dt_bias``/``A_log`` ramps, zeros for other
    1-D leaves, normal·0.02 for matrices."""
    if name.startswith("ln") or name in ("norm_scale", "D"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "dt_bias":
        ramp = torch.linspace(1e-3, 0.1, shape[0], device=device)
        return torch.log(torch.expm1(ramp)).to(dtype)
    if name == "A_log":
        ramp = torch.linspace(1.0, 16.0, shape[0], device=device)
        return torch.log(ramp).to(dtype)
    if len(shape) == 1:
        return torch.zeros(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=generator, device=device)
            * 0.02).to(dtype)


def _init_tree(generator, shapes, stack, dtype, device):
    """One layer's weights drawn and copied over the ``stack`` axes, as
    the reference does."""
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if isinstance(shape, dict):
            out[name] = _init_tree(generator, shape, stack, dtype, device)
            continue
        leaf = _init_leaf(name, shape, generator, dtype, device)
        out[name] = leaf.expand((*stack, *shape)).clone()
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=DEFAULT_DEVICE,
                opts: ModelOptions = DEFAULT_OPTIONS) -> Params:
    """Random parameters of the reference's distribution (not its bits),
    drawn on ``device`` from ``generator`` (which must live there)."""
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
    shapes = block_shapes(cfg)
    for kind, stack in sorted(_stack_counts(cfg).items()):
        params[f"{kind}_layers"] = _init_tree(generator, shapes[kind], stack,
                                              dtype, dev)
    return params


def param_shapes(cfg: ArchConfig, opts: ModelOptions = DEFAULT_OPTIONS):
    """The parameter tree of :func:`init_params` as
    :class:`~repro_torch.models.api.TensorSpec` leaves, without
    allocating: built on the ``meta`` device, as ``api.input_specs``
    builds the decode cache."""
    from repro_torch.models.api import specs_of
    return specs_of(init_params(cfg, torch.Generator(), "meta", opts))


def unstack_layers(stacked: Params, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree (views, no copy),
    each leaf unbound once. A DTensor stack sharded over its layers
    (FSDP's choice for a leaf whose layer count is its largest dim) is
    gathered first: a layer must be whole on every rank."""
    out = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = unstack_layers(v, n) if isinstance(v, dict) \
            else torch.unbind(gather_dim(v, 0))
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _n_stacked(stacked: Params) -> int:
    """The length of a stacked tree's leading axis."""
    leaf = next(iter(stacked.values()))
    return _n_stacked(leaf) if isinstance(leaf, dict) else leaf.shape[0]


def _head(cfg: ArchConfig, params: Params) -> torch.Tensor:
    """The LM head (d, V). A DTensor head has its FSDP shards gathered
    first, as :func:`embed_lookup` gathers the table: the
    cross-entropy's gather of the gold logit then meets the vocabulary
    sharded over the tensor-parallel axis at most."""
    if cfg.tie_embeddings:
        return gather_fsdp(params["embed"]).T
    return gather_fsdp(params["head"])


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A DTensor table has its FSDP shards gathered
    first (``gather_fsdp``), then is looked up on each rank's shards
    through ``local_map``, as Megatron's vocab-parallel embedding does:
    a rank returns its vocabulary shard's rows and zeros for the tokens
    outside it, summed over the vocabulary's mesh dimensions (one row
    and zeros: the sum is the row's bits). DTensor's own masked
    lookup refuses a table sharded in two dimensions, and its backward
    (``index_put`` of a sequence-sharded gradient) fails in torch 2.11."""
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    table = gather_fsdp(table)
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    tok = [Shard(0) if is_dtensor(tokens) and p.is_shard(0) else Replicate()
           for p in (tokens.placements if is_dtensor(tokens)
                     else [Replicate()] * mesh.ndim)]
    out = [Partial() if i in vocab else p for i, p in enumerate(tok)]
    grad = [Shard(0) if i in vocab else Partial() if p.is_shard() else
            Replicate() for i, p in enumerate(tok)]

    def body(tab, ids):
        first = 0
        for i in vocab:                  # this rank's vocabulary rows
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        ids = ids.long() - first * tab.shape[0]
        mine = (ids >= 0) & (ids < tab.shape[0])
        rows = tab[ids.clamp(0, tab.shape[0] - 1)]
        return torch.where(mine[..., None], rows, 0)

    fn = local_map(body, out_placements=out,
                   in_placements=(table.placements, tok),
                   in_grad_placements=(grad, tok), device_mesh=mesh)
    # the all-reduce at the lookup's end, as Megatron's: a pending sum
    # left in the residual stream would turn the next column-parallel
    # product into a whole-weight one on every rank
    return fn(table, sharding.place(tokens, mesh, tok)).redistribute(
        mesh, tok)


# --------------------------------------------------------------------------
# blocks (forward)
# --------------------------------------------------------------------------

def _qkv(cfg, p, h, src=None):
    """q from ``h``; k, v from ``src`` (``h`` unless cross-attention)."""
    src = h if src is None else src
    q, k, v = (L.matmul(h, p["wq"]), L.matmul(src, p["wk"]),
               L.matmul(src, p["wv"]))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _sp_gather(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Megatron-SP's gather: a sequence sharded between layers made
    whole before a tensor-parallel (column-split) weight; before a weight
    whole on every rank (ZeRO-3, context parallelism) it stays split."""
    if is_dtensor(w) and any(p.is_shard() for p in w.placements):
        return gather_dim(h, 1)
    return h


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """(B, S, n·hd) → (B, S, n, hd). A DTensor whose last dimension is
    sharded in pieces that are not whole heads is gathered first:
    DTensor refuses that view (XLA pads the heads instead)."""
    if is_dtensor(x) and any(
            p.is_shard(x.ndim - 1) and n_heads % x.device_mesh.size(i)
            for i, p in enumerate(x.placements)):
        x = gather_dim(x, -1)
    return x.reshape(*x.shape[:2], n_heads, hd)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, S, n, hd) → (B, S, n·hd). A DTensor with whole heads on every
    rank is reshaped on its local shards: DTensor's own view would meet,
    in the backward, a gradient sharded in pieces that are not whole
    heads (the row-parallel ``wo``'s)."""
    if is_dtensor(o) and not any(p.is_shard(2) for p in o.placements):
        from torch.distributed.tensor import DTensor
        loc = o.to_local()
        return DTensor.from_local(loc.reshape(*loc.shape[:2], -1),
                                  o.device_mesh, o.placements,
                                  run_check=False)
    return o.reshape(*o.shape[:2], -1)


def _attn_block(cfg, p, x, positions, opts, causal=True,
                kv: Optional[tuple] = None):
    """Pre-norm attention with residual. kv: optional (k_src, k_pos) for
    cross-attention (enc-dec): K/V from ``k_src``, keys at ``k_pos``, no
    RoPE and no window."""
    h = _sp_gather(L.rmsnorm(x, p["ln"]), p["wq"])
    q, k, v = _qkv(cfg, p, h,
                   None if kv is None else _sp_gather(kv[0], p["wk"]))
    b, sq = q.shape[:2]
    sk = k.shape[1]
    hd = cfg.head_dim
    q = L.constrain_qkv(_split_heads(q, cfg.n_heads, hd), opts)
    k = L.constrain_qkv(_split_heads(k, cfg.n_kv_heads, hd), opts,
                        is_kv=True)
    v = L.constrain_qkv(_split_heads(v, cfg.n_kv_heads, hd), opts,
                        is_kv=True)
    if kv is None:
        k_pos = positions
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    else:
        k_pos = kv[1]
    o = L.attention(q, k, v, positions, k_pos, causal=causal,
                    window=cfg.sliding_window if kv is None else None,
                    opts=opts)
    o = L.matmul(_merge_heads(L.constrain_qkv(o, opts)), p["wo"])
    return x + L.constrain(o, opts)


def _ffn_block(cfg, p, x, opts):
    """Pre-norm FFN with residual → (x, aux): the MoE router's
    load-balance loss, 0 for a dense FFN."""
    h = L.rmsnorm(x, p["ln"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "router" in p:                       # MoE FFN
        y, aux = M.moe_ffn(h, p, cfg.moe, opts.moe_impl, opts)
        return x + L.constrain(y, opts), aux
    h = _sp_gather(h, p["w1"] if "w1" in p else p["w_gate"])
    if "w1" in p:                           # GELU MLP
        y = L.gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"])
    else:                                   # SwiGLU
        y = L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return x + L.constrain(y, opts), aux


def _ssm_on_shards(h, sp, scfg):
    """:func:`~repro_torch.models.ssm.ssm_block` over a DTensor ``h``
    (sequence whole), through ``local_map``: each rank takes its batch
    shard and, where the mesh has a ``model`` dimension of more than one
    rank that the block's heads divide, its share of the heads, as the
    reference's XLA splits the block (Megatron's split of an SSM): its
    columns of z, x and dt and all of B and C (one group), its conv
    channels, the chunked scan on its heads, the gated norm's sum of
    squares all-reduced over ``model``, its rows of ``out_proj`` (a
    partial sum over ``model``). The weights enter whole, so the
    parameter tree keeps the reference's layout and placements; each
    rank slices its heads out (:func:`~repro_torch.models.ssm.
    head_shard`), and the gradients, zero outside a rank's slices, are
    summed over the batch's and the heads' mesh dimensions. Heads that
    ``model`` does not divide run whole on every ``model`` rank."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = h.device_mesh
    d = h.shape[-1]
    n_heads = S.ssm_dims(d, scfg)[1]
    place = [Shard(0) if p.is_shard(0) else Replicate()
             for p in h.placements]
    axes = mesh.mesh_dim_names or ()
    tp = axes.index("model") if "model" in axes else None
    if tp is not None and (mesh.size(tp) == 1 or n_heads % mesh.size(tp)
                           or place[tp].is_shard()):
        tp = None
    out = [Partial() if i == tp else p for i, p in enumerate(place)]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p.is_shard() or i == tp else Replicate()
            for i, p in enumerate(place)]
    names = sorted(sp)

    def body(x, *ws):
        params = dict(zip(names, ws))
        if tp is None:
            return S.ssm_block(x, params, scfg)
        params = S.head_shard(params, d, scfg, mesh.get_local_rank(tp),
                              mesh.size(tp))
        return S.ssm_block(x, params, scfg, psum=lambda t: funcol.all_reduce(
            t, "sum", (mesh, tp)))

    # h's gradient is placed as the output: each rank's heads' share
    fn = local_map(body, out_placements=out,
                   in_placements=(place, *[whole] * len(names)),
                   in_grad_placements=(out, *[grad] * len(names)),
                   device_mesh=mesh)
    return fn(sharding.place(h, mesh, place),
              *(sharding.place(sp[k], mesh, whole) for k in names))


def _ssm_layer(cfg, p, x, opts):
    h = gather_dim(L.rmsnorm(x, p["ln"]), 1)   # the scan reads it whole
    sp = {k: v for k, v in p.items() if k not in ("ln", "ffn")}
    block = _ssm_on_shards if is_dtensor(h) else S.ssm_block
    x = x + L.constrain(block(h, sp, cfg.ssm), opts)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p:
        x, aux = _ffn_block(cfg, p["ffn"], x, opts)
    return x, aux


def _attn_layer(cfg, p, x, positions, opts, causal=True):
    pa = {k: v for k, v in p.items() if k != "ffn"}
    x = _attn_block(cfg, pa, x, positions, opts, causal=causal)
    return _ffn_block(cfg, p["ffn"], x, opts)


def _hybrid_period(cfg, lp, x, positions, opts, causal=True):
    """One hybrid period: the attention layer, then its SSM layers (the
    MoE ones first, as the reference's scans)."""
    x, aux = _attn_layer(cfg, lp["attn"], x, positions, opts, causal)
    for kind in ("ssm_moe", "ssm_dense"):
        if kind in lp:
            for sp in unstack_layers(lp[kind], _n_stacked(lp[kind])):
                x, a = _ssm_layer(cfg, sp, x, opts)
                aux = aux + a
    return x, aux


# --------------------------------------------------------------------------
# backbone forward (train / prefill)
# --------------------------------------------------------------------------

def layer_params(lp: Params) -> Params:
    """One layer's parameters with their FSDP shards gathered (DTensors;
    plain tensors as they are): what the layer multiplies by, as FSDP
    gathers a layer's weights before it runs and the reference's XLA
    does inside its scan. Left to DTensor's strategy choice, torch 2.11
    gathers some tensor-parallel shards too and runs those products
    whole on every rank."""
    return {k: layer_params(v) if isinstance(v, dict) else gather_fsdp(v)
            for k, v in lp.items()}


def run_layer(opts: ModelOptions, fn, cfg, lp, *args):
    """``fn(cfg, lp, *args)`` with ``lp`` gathered by :func:`layer_params`
    inside, checkpointed under ``opts.remat`` and autograd (the
    reference's ``jax.checkpoint`` of a layer; the backward gathers
    again)."""
    def body(cfg, lp, *args):
        return fn(cfg, layer_params(lp), *args)

    if opts.remat and torch.is_grad_enabled():
        return checkpoint(body, cfg, lp, *args, use_reentrant=False)
    return body(cfg, lp, *args)


def _stacked_kinds(params: Params) -> Dict[str, Params]:
    """The hybrid's stacked trees by kind (attention and SSM stacks)."""
    out = {"attn": params["attn_layers"]}
    for kind in ("ssm_moe", "ssm_dense"):
        if f"{kind}_layers" in params:
            out[kind] = params[f"{kind}_layers"]
    return out


def backbone(cfg: ArchConfig, params: Params, x: torch.Tensor,
             positions: torch.Tensor, opts: ModelOptions,
             causal: bool = True) -> tuple:
    """The layer stack. x: (B,S,d) → (B,S,d), aux loss. Under
    ``opts.remat`` and autograd each layer (a hybrid: each period) keeps
    only its input and recomputes the rest in the backward."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for lp in unstack_layers(params["ssm_layers"], cfg.n_layers):
            x, a = run_layer(opts, _ssm_layer, cfg, lp, x, opts)
            x, aux = L.constrain(x, opts), aux + a
        return x, aux
    if cfg.hybrid_period:
        fn, n = _hybrid_period, cfg.n_layers // cfg.hybrid_period
        stacked = _stacked_kinds(params)
    else:
        fn, n = _attn_layer, cfg.n_layers
        stacked = params["attn_layers"]
    for lp in unstack_layers(stacked, n):
        x, a = run_layer(opts, fn, cfg, lp, x, positions, opts, causal)
        x, aux = L.constrain(x, opts), aux + a
    return x, aux


def embed_inputs(cfg: ArchConfig, params: Params,
                 batch: Dict[str, torch.Tensor], opts: ModelOptions):
    """tokens (+ optional stub modality embeddings) → (B,S,d),
    positions."""
    parts = []
    if cfg.vision_stub and "patch_embeds" in batch:
        parts.append(batch["patch_embeds"].to(opts.dtype))
    if cfg.audio_stub and "frame_embeds" in batch:
        parts.append(batch["frame_embeds"].to(opts.dtype))
    if "tokens" in batch:
        parts.append(embed_lookup(params["embed"], batch["tokens"]))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


@torch.no_grad()
def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Full forward to logits (B,S,V)."""
    x, positions = embed_inputs(cfg, params, batch, opts)
    x, _ = backbone(cfg, params, x, positions, opts)
    x = L.rmsnorm(x, gather_fsdp(params["final_norm"]))
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
        # the gold logit stays (B, c, 1) until it meets lse: over a
        # vocabulary-sharded DTensor it is a masked partial sum, whose
        # mask DTensor applies by the gather's own shape
        gold = torch.gather(logits, -1, ll.clamp(min=0)[..., None])
        valid = ll >= 0
        tot = tot + torch.where(valid, (lse[..., None] - gold)[..., 0],
                                0.0).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp(min=1)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            opts: ModelOptions = DEFAULT_OPTIONS) -> torch.Tensor:
    """Scalar training loss: chunked cross-entropy of the next-token
    labels (-1 = no target), the stub modality prefix carrying none,
    plus 0.01 × the MoE load-balance loss (0 without MoE)."""
    x, positions = embed_inputs(cfg, params, batch, opts)
    x, aux = backbone(cfg, params, x, positions, opts)
    x = gather_dim(L.rmsnorm(x, gather_fsdp(params["final_norm"])), 1)
    # (gathered: the CE chunks the sequence)
    labels = batch["labels"]
    if labels.shape[1] != x.shape[1]:       # stub modality prefix: no loss
        labels = F.pad(labels, (x.shape[1] - labels.shape[1], 0), value=-1)
    ce = _chunked_ce(x, _head(cfg, params), labels)
    return ce + 0.01 * aux


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------

def _kv_cache_len(cfg: ArchConfig, max_seq: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def _kv_cache(cfg: ArchConfig, n: int, batch: int, s: int, dtype, dev):
    hd, kh = cfg.head_dim, cfg.n_kv_heads
    return {
        "k": torch.zeros((n, batch, s, kh, hd), dtype=dtype, device=dev),
        "v": torch.zeros((n, batch, s, kh, hd), dtype=dtype, device=dev),
        "kpos": torch.full((n, batch, s), EMPTY_POS, dtype=torch.int32,
                           device=dev),
    }


def _ssm_cache(cfg: ArchConfig, stack, batch: int, dtype, dev) -> S.SSMCache:
    base = S.init_ssm_cache(batch, cfg.d_model, cfg.ssm, dtype, dev)
    return S.SSMCache(*(t.expand((*stack, *t.shape)).clone() for t in base))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               opts: ModelOptions = DEFAULT_OPTIONS,
               device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Decode cache (zeros; kpos 2**30 marks empty slots): a ring buffer
    of ``min(sliding_window, max_seq)`` slots per attention layer, an
    :class:`~repro_torch.models.ssm.SSMCache` stacked per SSM layer."""
    dev = resolve_device(device)
    s = _kv_cache_len(cfg, max_seq)
    cache: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family == "ssm":
        cache["ssm"] = _ssm_cache(cfg, (cfg.n_layers,), batch, opts.dtype,
                                  dev)
    elif cfg.hybrid_period:
        n_per = cfg.n_layers // cfg.hybrid_period
        cache["attn"] = _kv_cache(cfg, n_per, batch, s, opts.dtype, dev)
        n_moe, n_dense = hybrid_ssm_split(cfg)
        for kind, n in (("ssm_moe", n_moe), ("ssm_dense", n_dense)):
            if n:
                cache[kind] = _ssm_cache(cfg, (n_per, n), batch, opts.dtype,
                                         dev)
    else:
        cache["attn"] = _kv_cache(cfg, cfg.n_layers, batch, s, opts.dtype,
                                  dev)
    return cache


def _attn_decode_block(cfg, p, x, pos, kcache):
    """x: (B,1,d); kcache: dict(k,v,kpos) of THIS layer, (B,S,KH,hd)
    views into the stacked cache, updated in place."""
    b = x.shape[0]
    h = L.rmsnorm(x, p["ln"])
    q, k, v = _qkv(cfg, p, h)
    hd = cfg.head_dim
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(k, cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)
    qpos = pos[:, None]                                    # (B,1)
    q = L.apply_rope(q, qpos, cfg.rope_theta)
    k = L.apply_rope(k, qpos, cfg.rope_theta)

    if is_dtensor(kcache["k"]):
        o = L.decode_on_shards(q, k, v, pos, kcache, cfg.sliding_window)
        return settle(x + _merge_heads(o) @ p["wo"])
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


def _ssm_decode_layer(cfg, p, x, cache: S.SSMCache, opts):
    """One SSM layer's decode step; ``cache`` holds views into the
    stacked cache and is updated in place."""
    h = L.rmsnorm(x, p["ln"])
    sp = {k: v for k, v in p.items() if k not in ("ln", "ffn")}
    y, new = S.ssm_block_decode(h, sp, cfg.ssm, cache)
    cache.conv.copy_(new.conv)
    cache.state.copy_(new.state)
    x = settle(x + y)
    if "ffn" in p:
        x, _ = _ffn_block(cfg, p["ffn"], x, opts)
    return settle(x)


def _attn_decode_layer(cfg, lp, x, pos, kcache, opts):
    pa = {k: v for k, v in lp.items() if k != "ffn"}
    x = _attn_decode_block(cfg, pa, x, pos, kcache)
    x, _ = _ffn_block(cfg, lp["ffn"], x, opts)
    return settle(x)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                batch: Dict[str, torch.Tensor],
                opts: ModelOptions = DEFAULT_OPTIONS):
    """One-token decode. batch: {tokens: (B,1)}. Returns (logits (B,V),
    cache). Unlike the reference, the KV tensors and SSM states of
    ``cache`` are updated IN PLACE (one cache, not one per step); the
    returned dict shares them and carries ``pos + 1``."""
    x = embed_lookup(params["embed"], batch["tokens"]).to(opts.dtype)   # (B,1,d)
    pos = cache["pos"]

    def layer_of(tree, i):
        if isinstance(tree, S.SSMCache):
            return S.SSMCache(*(t[i] for t in tree))
        return {name: t[i] for name, t in tree.items()}

    if cfg.family == "ssm":
        for i, lp in enumerate(unstack_layers(params["ssm_layers"],
                                              cfg.n_layers)):
            x = _ssm_decode_layer(cfg, layer_params(lp), x,
                                  layer_of(cache["ssm"], i), opts)
    elif cfg.hybrid_period:
        stacked = _stacked_kinds(params)
        n_per = cfg.n_layers // cfg.hybrid_period
        for i, lp in enumerate(unstack_layers(stacked, n_per)):
            lp = layer_params(lp)
            x = _attn_decode_layer(cfg, lp["attn"], x, pos,
                                   layer_of(cache["attn"], i), opts)
            for kind in ("ssm_moe", "ssm_dense"):
                if kind not in lp:
                    continue
                sc = layer_of(cache[kind], i)
                for j, sp in enumerate(unstack_layers(
                        lp[kind], _n_stacked(lp[kind]))):
                    x = _ssm_decode_layer(cfg, sp, x, layer_of(sc, j), opts)
    else:
        for i, lp in enumerate(unstack_layers(params["attn_layers"],
                                              cfg.n_layers)):
            x = _attn_decode_layer(cfg, layer_params(lp), x, pos,
                                   layer_of(cache["attn"], i), opts)
    x = L.rmsnorm(x, gather_fsdp(params["final_norm"]))
    logits = (x @ _head(cfg, params))[:, 0]
    return logits, {**cache, "pos": pos + 1}
