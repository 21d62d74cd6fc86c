"""Core transformer layers in PyTorch: the port of the reference
package's ``repro.models.layers``.

Attention has three implementations selectable via
``ModelOptions.attn_impl``:

  * ``naive``       — materializes (B,H,S,S) scores. Reference semantics.
  * ``flash_torch`` — blockwise online softmax in plain PyTorch (the
                      reference's ``flash_jnp``) with a blockwise-recompute
                      backward: O(block_q x block_kv) live scores in both
                      directions.
  * ``cuda``        — the hand-written Hopper kernel behind
                      ``repro_torch.kernels.ops.flash_attention`` (the
                      reference's ``pallas``); on CPU tensors its plain
                      version. Forward only: it raises under autograd, as
                      ``jax.grad`` through the Pallas kernel does.

``auto`` chooses as the reference does: naive up to ``flash_threshold``
keys, ``flash_torch`` above, never the kernel.

Weights keep the reference's (in, out) layout, so a converted reference
parameter tree is used as it is. The sharding constraints place
DTensors on the current mesh (:mod:`repro_torch.parallel.sharding`);
:func:`attention` given DTensors runs on each rank's batch and head
shards (Megatron's head split makes attention shard-local), and
:func:`ring_attention` is the context-parallel attention over a mesh
axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.parallel import sharding

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Runtime (non-architectural) knobs."""
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"          # auto | naive | flash_torch | cuda
    block_q: int = 512
    block_kv: int = 1024
    remat: bool = True               # activation checkpointing per layer
    moe_impl: str = "gather"         # gather | dense_dispatch | ep_a2a
    # sequence threshold above which "auto" switches naive → flash_torch
    flash_threshold: int = 2048
    # Megatron-SP: partition spec (parallel.sharding.P) applied to the
    # residual stream at layer boundaries
    act_spec: object = None
    # attention-internal layout: (batch, seq, heads, hd) — heads over
    # `model` (the Megatron decomposition)
    qkv_spec: object = None
    # separate spec for K/V: GQA kv-head count may not divide the model
    # axis (then KV heads are replicated across the TP group)
    kv_spec: object = None
    # explicit expert parallelism (moe_impl="ep_a2a"): experts sharded
    # over `ep_axis`, tokens over `dp_axes` (+ seq over ep_axis)
    ep_axis: object = None
    dp_axes: object = None


def _constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` placed by ``spec`` on the current mesh (which must exist),
    a dimension that the named axes do not divide left replicated:
    DTensor shards it unevenly and then refuses views of it (XLA pads
    it instead)."""
    mesh = sharding.current_mesh()
    fit = [e if e is None or x.shape[d] % sharding._axis_size(mesh, e) == 0
           else None for d, e in enumerate(spec)]
    return sharding.distribute(x, sharding.P(*fit), mesh)


def constrain(x: torch.Tensor, opts: ModelOptions) -> torch.Tensor:
    """Residual-stream sharding constraint: with ``opts.act_spec``, ``x``
    placed by it on the current mesh; without, ``x`` as it is."""
    if opts.act_spec is not None:
        return _constrain(x, opts.act_spec)
    return x


def constrain_qkv(x: torch.Tensor, opts: ModelOptions,
                  is_kv: bool = False) -> torch.Tensor:
    """Attention-layout sharding constraint (``opts.kv_spec`` for K/V,
    ``opts.qkv_spec`` otherwise), as :func:`constrain`."""
    spec = opts.kv_spec if is_kv else opts.qkv_spec
    if spec is not None:
        return _constrain(x, spec)
    return x


DEFAULT_OPTIONS = ModelOptions()


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

#: ``x · rsqrt(mean(x²) + eps) · scale`` in fp32, cast back: one body
#: for the model, the kernel's plain version and the tests
rmsnorm = rmsnorm_ref


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., :, None].float() * freqs            # (...,S,hd/2)
    sin = torch.sin(ang)[..., :, None, :]                    # over heads
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,KH,hd) → (B,S,KH*n_rep,hd): query head h reads KV head
    h // n_rep."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    k = k[:, :, :, None, :].expand(b, s, kh, n_rep, hd)
    return k.reshape(b, s, kh * n_rep, hd)


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        causal: bool, window: Optional[int]) -> torch.Tensor:
    """Boolean mask (..., Q, K): True = attend."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window is not None:
        m &= d < window
    return m


class _TensorCoreDots(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` of bf16 ``a``, ``b``
    (the tensor cores' product, exact products summed in fp32), with the
    backward of the upcast product ``bmm(a.float(), b.float())``: each
    gradient an fp32 GEMM of the fp32 cotangent and the other operand,
    rounded to bf16. torch 2.11 has no derivative for the ``out_dtype``
    product."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _dots(a, b):
    """``a·bᵀ`` over the last two dims: (..., Q, hd) x (..., K, hd) →
    (..., Q, K) in fp32, the reference's ``preferred_element_type=
    float32`` (bf16 products are exact in fp32 and summed in fp32). bf16
    on the card runs on the tensor cores with an fp32 output
    (:class:`_TensorCoreDots`); everything else is upcast to an fp32
    GEMM (no TF32 unless the process allows it)."""
    lead, q, k = a.shape[:-2], a.shape[-2], b.shape[-2]
    a3 = a.reshape(-1, q, a.shape[-1])
    b3 = b.reshape(-1, k, b.shape[-1]).transpose(1, 2)
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        out = _TensorCoreDots.apply(a3, b3)
    else:
        out = torch.bmm(a3.float(), b3.float())
    return out.view(*lead, q, k)


def attention_naive(q, k, v, q_pos, k_pos, causal=True, window=None):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KH,hd). Returns (B,Sq,H,hd)."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    logits = _dots(q.transpose(1, 2), k.transpose(1, 2)) * q.shape[-1] ** -0.5
    mask = _causal_window_mask(q_pos, k_pos, causal, window)   # (B,Q,K)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _blockify(x, block, pad_value=0.0):
    """(B, S, ...) → (nblocks, B, block, ...)."""
    b, s = x.shape[:2]
    p = (-s) % block
    if p:
        pads = [0, 0] * (x.dim() - 2) + [0, p]
        x = F.pad(x, pads, value=pad_value)
    n = x.shape[1] // block
    x = x.reshape((b, n, block) + tuple(x.shape[2:]))
    return x.movedim(1, 0)


#: how a (q block, kv block) pair of the blockwise attention is treated
SKIP, PARTIAL, FULL = 0, 1, 2


def _block_pairs(q_pos, k_pos, causal, window, block_q, block_kv):
    """``pairs[i][j]`` for q block ``i`` and kv block ``j``: ``SKIP`` when
    the masks leave no entry of the pair (it would add exactly nothing to
    any row that attends to some key), ``FULL`` when they leave every
    entry (the mask is the identity), ``PARTIAL`` otherwise. Decided from
    each block's range of valid positions over the batch, so a pair is
    never skipped while one entry survives; one copy to the host
    (:func:`_on_host`)."""
    big = 2 ** 62
    qp = _blockify(q_pos.long(), block_q, pad_value=-1).flatten(1)
    kp = _blockify(k_pos.long(), block_kv, pad_value=2 ** 30).flatten(1)
    qv, kv = qp >= 0, kp < 2 ** 29
    nq, nk = qp.shape[0], kp.shape[0]
    flat = torch.cat([qp.masked_fill(~qv, big).amin(1), qp.amax(1),
                      qv.all(1).long(), kp.amin(1),
                      kp.masked_fill(~kv, -big).amax(1),
                      kv.all(1).long()])
    flat = _on_host(flat).tolist()
    qmin, qmax, qall = (flat[i * nq:(i + 1) * nq] for i in range(3))
    kmin, kmax, kall = (flat[3 * nq + i * nk:3 * nq + (i + 1) * nk]
                        for i in range(3))
    pairs = []
    for i in range(nq):
        row = []
        for j in range(nk):
            some = (qmax[i] >= 0 and kmin[j] < 2 ** 29
                    and (not causal or kmin[j] <= qmax[i])
                    and (window is None or qmin[i] - kmax[j] < window))
            every = (qall[i] and kall[j]
                     and (not causal or qmin[i] >= kmax[j])
                     and (window is None or qmax[i] - kmin[j] < window))
            row.append(FULL if every else PARTIAL if some else SKIP)
        pairs.append(row)
    return pairs


def _on_host(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values on the host. A fake tensor (a step traced under
    ``FakeTensorMode``, which holds no data) has them where its fake
    mode carries them (``repro_torch.core.roofline.TraceCounter`` does
    for small integer tensors made from known values); otherwise this
    raises rather than guess."""
    if not is_fake(t):
        return t.cpu()
    values_of = getattr(t.fake_mode, "values_of", None)
    values = values_of(t) if values_of is not None else None
    if values is None:
        raise RuntimeError(
            "the blockwise attention decides its block pairs from the "
            "positions' values, and this trace does not know them (the "
            "positions were received from another rank or made from "
            "unknown data)")
    return values


def _block_mask(qpblk, kpblk, causal, window):
    """(B,bq,bkv) mask of one block pair, padding included."""
    msk = _causal_window_mask(qpblk, kpblk, causal, window)
    return msk & (kpblk < 2 ** 29)[:, None, :] & (qpblk >= 0)[:, :, None]


def _heads(x, n_rep, block):
    """(B,S,KH,hd) → contiguous (B, KH·n_rep, S', hd), S' = S padded with
    zeros to whole blocks: the head-major layout in which a block is a
    view. Query head h reads KV head h // n_rep."""
    b, s, kh, hd = x.shape
    out = x.new_zeros((b, kh, n_rep, s + (-s) % block, hd))
    out[:, :, :, :s] = x.transpose(1, 2)[:, :, None]
    return out.view(b, kh * n_rep, -1, hd)


def _flash_fwd_impl(q, k, v, q_pos, k_pos, causal, window,
                    block_q, block_kv, pairs):
    """Blockwise online softmax. q (B,H,Sq',hd) and k, v (B,H,Sk',hd) in
    the :func:`_heads` layout (KV heads repeated), positions (B,Sq) and
    (B,Sk). Returns out (B,H,Sq',hd) in q's dtype and lse (B,H,Sq') in
    fp32. ``pairs`` from :func:`_block_pairs`: skipped pairs and
    unneeded masks change no value (a row with no valid key at all is
    undefined)."""
    b, h, _, hd = q.shape
    scale = hd ** -0.5
    qposb = _blockify(q_pos, block_q, pad_value=-1)
    kposb = _blockify(k_pos, block_kv, pad_value=2 ** 30)

    outs, lses = [], []
    for i, (qpblk, row) in enumerate(zip(qposb, pairs)):   # (B,bq)
        qblk = q[:, :, i * block_q:(i + 1) * block_q]
        m = torch.full((b, h, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, block_q, hd), dtype=torch.float32,
                          device=q.device)
        for j, (kpblk, kind) in enumerate(zip(kposb, row)):
            if kind == SKIP:
                continue
            ks = slice(j * block_kv, (j + 1) * block_kv)
            logits = _dots(qblk, k[:, :, ks]).mul_(scale)  # (B,H,bq,bkv)
            if kind == PARTIAL:
                msk = _block_mask(qpblk, kpblk, causal, window)
                logits.masked_fill_(~msk[:, None], NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = logits.sub_(m_new[..., None]).exp_()
            l = l * alpha + p.sum(dim=-1)
            acc.mul_(alpha[..., None]).add_(p.to(q.dtype) @ v[:, :, ks])
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None])
                    .to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _flash_bwd_impl(q, k, v, q_pos, k_pos, out, lse, dout, causal, window,
                    block_q, block_kv, pairs):
    """FlashAttention backward: blockwise recompute of p from (q, k, lse).
    Live memory O(block_q x block_kv); no O(S²) residuals. The layout of
    :func:`_flash_fwd_impl`, dout like out; returns dq, and dk, dv per
    query head, in fp32 and that layout. ds is scaled before its cast to
    q's dtype, as the reference rounds it (p·(dp − δ), then ·scale); the
    scale rides on the cast's pass."""
    b, h, _, hd = q.shape
    scale = hd ** -0.5
    delta = (dout.float() * out.float()).sum(dim=-1)        # (B,H,Sq')
    neg_lse = -lse[..., None]
    qposb = _blockify(q_pos, block_q, pad_value=-1)
    kposb = _blockify(k_pos, block_kv, pad_value=2 ** 30)

    def zeros(block):
        return torch.zeros((b, h, block, hd), dtype=torch.float32,
                           device=q.device)

    dq = [zeros(block_q) for _ in qposb]
    dks, dvs = [], []
    for j, kpblk in enumerate(kposb):
        ks = slice(j * block_kv, (j + 1) * block_kv)
        kblk, vblk = k[:, :, ks], v[:, :, ks]
        dk, dv = zeros(block_kv), zeros(block_kv)
        for i, qpblk in enumerate(qposb):
            kind = pairs[i][j]
            if kind == SKIP:
                continue
            qs = slice(i * block_q, (i + 1) * block_q)
            qblk, doblk = q[:, :, qs], dout[:, :, qs]
            p = torch.add(neg_lse[:, :, qs], _dots(qblk, kblk),
                          alpha=scale).exp_()               # (B,H,bq,bkv)
            if kind == PARTIAL:
                msk = _block_mask(qpblk, kpblk, causal, window)
                p.masked_fill_(~msk[:, None], 0.0)
            dv.add_(p.to(dout.dtype).transpose(-1, -2) @ doblk)
            dp = _dots(doblk, vblk).sub_(delta[:, :, qs, None])
            # p·(dp − δ), then ·scale as the cast's own pass: the
            # reference's operand order and rounding points
            ds = torch.mul(dp.mul_(p), scale,
                           out=torch.empty_like(dp, dtype=q.dtype))
            dq[i].add_(ds @ kblk)
            dk.add_(ds.transpose(-1, -2) @ qblk)
        dks.append(dk)
        dvs.append(dv)
    return (torch.cat(dq, dim=2), torch.cat(dks, dim=2),
            torch.cat(dvs, dim=2))


class _FlashCore(torch.autograd.Function):
    """The reference's ``custom_vjp`` around ``_flash_core`` as one
    Function: the blockwise forward, and a backward that recomputes p
    block by block from what it saved — q (in its head-major layout),
    the un-repeated k and v, out and lse. The backward repeats K/V again,
    casts each query head's dk, dv to k's dtype and then adds them up
    over the query heads of a KV head, one head after the other in k's
    dtype: the reference's ``custom_vjp`` returns per-head gradients in
    k's dtype, and the transpose of its ``_repeat_kv`` adds them up in
    that order."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, block_q,
                block_kv):
        n_rep = q.shape[2] // k.shape[2]
        pairs = _block_pairs(q_pos, k_pos, causal, window, block_q,
                             block_kv)
        qh = _heads(q, 1, block_q)
        out, lse = _flash_fwd_impl(qh, _heads(k, n_rep, block_kv),
                                   _heads(v, n_rep, block_kv), q_pos, k_pos,
                                   causal, window, block_q, block_kv, pairs)
        ctx.save_for_backward(qh, k, v, q_pos, k_pos, out, lse)
        ctx.meta = (causal, window, block_q, block_kv, pairs)
        return out[:, :, :q.shape[1]].transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        qh, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        causal, window, block_q, block_kv, pairs = ctx.meta
        b, sk, kh, hd = k.shape
        sq, n_rep = q_pos.shape[1], qh.shape[1] // kh
        dq, dk, dv = _flash_bwd_impl(
            qh, _heads(k, n_rep, block_kv), _heads(v, n_rep, block_kv),
            q_pos, k_pos, out, lse, _heads(dout, 1, block_q), causal,
            window, block_q, block_kv, pairs)

        def per_kv_head(g):      # the gradient of repeating K/V
            g = g.view(b, kh, n_rep, -1, hd)[:, :, :, :sk].to(k.dtype)
            total = g[:, :, 0]
            for r in range(1, n_rep):        # in k's dtype, head by head
                total = total + g[:, :, r]
            return total.transpose(1, 2)

        return (dq[:, :, :sq].transpose(1, 2).to(qh.dtype), per_kv_head(dk),
                per_kv_head(dv), None, None, None, None, None, None)


def attention_flash_torch(q, k, v, q_pos, k_pos, causal=True, window=None,
                          block_q=512, block_kv=1024):
    """Blockwise (FlashAttention-style) online-softmax attention in plain
    PyTorch with a flash BACKWARD (blockwise recompute from lse):
    O(block_q x block_kv) live scores in both directions."""
    return _FlashCore.apply(q, k, v, q_pos, k_pos, causal, window,
                            min(block_q, q.shape[1]),
                            min(block_kv, k.shape[1]))


def attention_decode(q, k_cache, v_cache, q_pos, k_pos, window=None,
                     reduce=None):
    """Single-step decode attention.

    q: (B,1,H,hd); caches: (B,S,KH,hd); k_pos: (B,S) absolute positions of
    cache slots (2**30 marks empty slots — they mask out via causality).

    ``reduce(t, op)`` (``op`` "max" or "sum") completes a reduction
    over the keys of other ranks, when the caches hold this rank's part
    of the sequence (:func:`decode_on_shards`): the softmax's max and
    sum are reduced before the probabilities are formed, so they round
    to q's dtype and multiply the cache in its dtype as on one rank,
    and the parts of the output are summed in fp32.
    """
    kh = k_cache.shape[2]
    n_rep = q.shape[2] // kh
    b = k_cache.shape[0]
    hd = q.shape[-1]
    # grouped-query einsum without materializing repeated KV
    qg = q.reshape(b, 1, kh, n_rep, hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                          k_cache.float()) * hd ** -0.5
    valid = k_pos[:, None, :] <= q_pos[:, :, None]          # (B,1,S)
    if window is not None:
        valid &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    if reduce is None:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
    else:
        p = torch.exp(logits - reduce(logits.amax(dim=-1, keepdim=True),
                                      "max"))
        probs = (p / reduce(p.sum(dim=-1, keepdim=True), "sum")).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v_cache)
    if reduce is not None:
        out = reduce(out.float(), "sum").to(out.dtype)
    return out.reshape(b, 1, kh * n_rep, hd)


def _cache_shards(kc):
    """How a DTensor cache (B, S, KH, hd) is split: its mesh, the mesh
    dims that split its sequence, the placements of its batch (and of
    anything split like it, the positions) and of a query (B, 1, H, hd)
    split as it splits batch and KV heads."""
    from torch.distributed.tensor import Replicate, Shard
    seq_dims = [i for i, p in enumerate(kc.placements) if p.is_shard(1)]
    head_dims = {i for i, p in enumerate(kc.placements) if p.is_shard(2)}
    batch = [Shard(0) if p.is_shard(0) else Replicate()
             for p in kc.placements]
    q_place = [Shard(2) if i in head_dims else p
               for i, p in enumerate(batch)]
    return kc.device_mesh, seq_dims, batch, q_place


def _first_slot(mesh, seq_dims, s_loc: int) -> int:
    """The first of this rank's ``s_loc`` slots of a sequence split over
    ``seq_dims``."""
    first = 0
    for i in seq_dims:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    return first * s_loc


def _seq_reduce(mesh, seq_dims):
    """:func:`attention_decode`'s ``reduce`` over the ranks that hold the
    parts of a split sequence (None for a whole one): one all-reduce,
    over the mesh dimensions flattened into one where the sequence is
    split over several (a ring over all their ranks moves less than a
    ring over each in turn)."""
    import torch.distributed._functional_collectives as funcol
    if not seq_dims:
        return None
    group = (mesh, seq_dims[0])
    if len(seq_dims) > 1:
        from torch.utils._python_dispatch import _disable_current_modes
        names = mesh.mesh_dim_names
        with _disable_current_modes():   # the mesh's own tensors are real
            group = mesh[tuple(names[i] for i in seq_dims)]._flatten()

    def reduce(t, op):
        return funcol.all_reduce(t, op, group)
    return reduce


def decode_on_shards(q, k, v, pos, cache, window=None):
    """One decode step's attention over a DTensor KV cache: write the new
    token's k, v and position into ``cache`` (this layer's ``k``, ``v``
    (B, S, KH, hd) and ``kpos`` (B, S), placed as ``cache_specs`` places
    them) in place, then attend. Runs on each rank's shards through
    ``local_map``: batch and KV heads as the cache splits them (the query
    heads alike), the whole new token on every rank of a sharded
    sequence, which writes it only where its slot falls in the rank's
    range. :func:`attention_decode` attends on each rank; a sequence
    split over ranks is attended in parts, each against the rank's
    keys, with the softmax's max and sum and the output all-reduced over
    those ranks (its ``reduce``). q (B,1,H,hd), k, v (B,1,KH,hd), pos
    (B,)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    kc = cache["k"]
    mesh, seq_dims, batch, q_place = _cache_shards(kc)
    kpos_place = cache["kpos"].placements

    def body(q, k, v, pos, kc, vc, kp):
        b, s_loc = kc.shape[:2]
        first = _first_slot(mesh, seq_dims, s_loc)
        bi = torch.arange(b, device=q.device)
        slot = (pos % (kp.shape[1])).long()
        here = slot - first
        mine = (here >= 0) & (here < s_loc)
        here = here.clamp(0, s_loc - 1)
        for buf, new in ((kc, k), (vc, v)):
            buf[bi, here] = torch.where(mine[:, None, None], new[:, 0],
                                        buf[bi, here])
        kp[bi, slot] = pos
        keys = kp[:, first:first + s_loc]
        return attention_decode(q, kc, vc, pos[:, None], keys, window,
                                _seq_reduce(mesh, seq_dims))

    kv_new = [Replicate() if i in seq_dims else p
              for i, p in enumerate(kc.placements)]
    fn = local_map(body, out_placements=q_place,
                   in_placements=(q_place, kv_new, kv_new, batch,
                                  kc.placements, kc.placements, kpos_place),
                   device_mesh=mesh)
    return fn(sharding.place(q, mesh, q_place),
              *(sharding.place(t, mesh, kv_new) for t in (k, v)),
              sharding.place(pos, mesh, batch), kc, cache["v"],
              cache["kpos"])


def attend_cache_on_shards(q, kc, vc, q_pos, k_pos):
    """:func:`attention_decode` of q (B,1,H,hd) at ``q_pos`` (B,1) over a
    DTensor cache ``kc``, ``vc`` (B, S, KH, hd) that is read, not written
    (the enc-dec model's cross-attention K/V), its slots at ``k_pos``
    (B, S), on each rank's shards as :func:`decode_on_shards` attends."""
    from torch.distributed.tensor.experimental import local_map
    mesh, seq_dims, batch, q_place = _cache_shards(kc)

    def body(q, kc, vc, q_pos, kp):
        first = _first_slot(mesh, seq_dims, kc.shape[1])
        return attention_decode(q, kc, vc, q_pos,
                                kp[:, first:first + kc.shape[1]], None,
                                _seq_reduce(mesh, seq_dims))

    fn = local_map(body, out_placements=q_place,
                   in_placements=(q_place, kc.placements, vc.placements,
                                  batch, batch), device_mesh=mesh)
    return fn(sharding.place(q, mesh, q_place), kc, vc,
              *(sharding.place(t, mesh, batch) for t in (q_pos, k_pos)))


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
              opts: ModelOptions = DEFAULT_OPTIONS):
    if sharding.is_dtensor(q):
        return _sharded_attention(q, k, v, q_pos, k_pos, causal, window,
                                  opts)
    impl = opts.attn_impl
    if impl == "auto":
        impl = "flash_torch" if k.shape[1] > opts.flash_threshold \
            else "naive"
    if impl == "naive":
        return attention_naive(q, k, v, q_pos, k_pos, causal, window)
    if impl == "flash_torch":
        return attention_flash_torch(q, k, v, q_pos, k_pos, causal, window,
                                     opts.block_q, opts.block_kv)
    if impl == "cuda":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                    window=window)
    raise ValueError(f"unknown attn_impl {impl!r}")


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous.

    A rank's attention hands DTensor its gradients of q, k and v, and
    DTensor takes every local shard for contiguous: it decides views by
    the global strides it infers, not the shard's own. The score
    product's backward (:func:`_dots`) leaves k's gradient in the layout
    of ``kᵀ`` (sequence stride 1), and elementwise ops after it keep that
    layout. With one head a rank (t5_large's 16 heads over 16 ranks),
    DTensor then merges the heads by a view that the shard allows and
    the matmul's backward folds the result (B, S, d) to (B·S, d) by one
    that it does not."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sharded_attention(q, k, v, q_pos, k_pos, causal, window, opts):
    """:func:`attention` over DTensors: the chosen implementation on each
    rank's shards, through ``local_map``. q's placements decide; a
    pending sum (``Partial``) is reduced first. Batch (dim 0), sequence
    (dim 1) and heads (dim 2) may be sharded; K, V and the positions are
    placed to match, except that K and V stay whole along a mesh
    dimension where q's sequence is split (each rank's queries attend to
    every key, at their absolute positions: context parallelism by an
    all-gather) or where the query heads split and the KV heads do not
    (GQA with fewer KV heads than ranks: each rank attends with the KV
    heads its query heads read). Gradients of K and V are summed over
    such a dimension. A mesh dimension of size 1 shards nothing and
    counts as replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    place, kv_place, kv_grad, qpos_place, kpos_place = [], [], [], [], []
    kv_dim = None
    for i, p in enumerate(q.placements):
        if p.is_partial() or (p.is_shard() and mesh.size(i) == 1):
            p = Replicate()
        if p.is_shard() and p.dim not in (0, 1, 2):
            raise ValueError(
                f"attention runs shard-local over batch, sequence and "
                f"heads only; q is placed {q.placements} (dimension "
                f"{p.dim} sharded over mesh axis "
                f"{mesh.mesh_dim_names[i]!r})")
        kp, kg = p, None
        if p.is_shard(2):
            hq, n_rep = q.shape[2] // mesh.size(i), q.shape[2] // k.shape[2]
            if q.shape[2] % mesh.size(i) or (
                    k.shape[2] % mesh.size(i)
                    and (kv_dim is not None
                         or (hq % n_rep and n_rep % hq))):
                raise ValueError(
                    f"{q.shape[2]} query and {k.shape[2]} KV heads do not "
                    f"split over {mesh.size(i)} ranks")
            if k.shape[2] % mesh.size(i):
                kv_dim, kp, kg = i, Replicate(), Partial()
        elif p.is_shard(1):
            kp, kg = Replicate(), Partial()
        place.append(p)
        kv_place.append(kp)
        kv_grad.append(kg or kp)
        qpos_place.append(p if p.is_shard() and p.dim < 2 else Replicate())
        kpos_place.append(Shard(0) if kp.is_shard(0) else Replicate())

    def body(q, k, v, q_pos, k_pos):
        # gradients handed back to DTensor contiguous, as it assumes
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        if kv_dim is not None:           # this rank's query heads' KV heads
            hq = q.shape[2]
            n_rep = hq * mesh.size(kv_dim) // k.shape[2]
            first = mesh.get_local_rank(kv_dim) * hq
            kv = slice(first // n_rep, (first + hq - 1) // n_rep + 1)
            k, v = k[:, :, kv], v[:, :, kv]
        return attention(q, k, v, q_pos, k_pos, causal=causal,
                         window=window, opts=opts)

    # one output: its placements a list (local_map reads a tuple as one
    # entry per output)
    fn = local_map(body, out_placements=place,
                   in_placements=(place, kv_place, kv_place, qpos_place,
                                  kpos_place),
                   in_grad_placements=(place, kv_grad, kv_grad, qpos_place,
                                       kpos_place),
                   device_mesh=mesh)
    return fn(sharding.place(q, mesh, place),
              *(sharding.place(x, mesh, kv_place) for x in (k, v)),
              sharding.place(q_pos, mesh, qpos_place),
              sharding.place(k_pos, mesh, kpos_place))


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``. A DTensor ``x`` sharded somewhere but in its last
    (contracted) dimension, times a weight whole on every rank, is
    multiplied on each rank's shard (the weight's gradient summed over
    ``x``'s sharded mesh dimensions): DTensor's own product flattens a
    batch and a sequence sharded over two mesh axes into one dimension,
    which it cannot propagate under fake tensors. An ``x`` split in its
    contracted dimension (a column-parallel product's output meeting a
    weight that no rule splits) is left to DTensor, which multiplies
    each shard by its rows of ``w`` into a pending sum."""
    if not (sharding.is_dtensor(x) and sharding.is_dtensor(w)
            and all(p.is_replicate() for p in w.placements)
            and any(p.is_shard() for p in x.placements)
            and not any(p.is_shard(x.ndim - 1) for p in x.placements)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    place = list(x.placements)
    # a pending sum in x stays one in the product (it is linear); each of
    # its terms gets the whole gradient, and w's gradient is summed over
    # its mesh dimensions as over x's shards
    x_grad = [Replicate() if p.is_partial() else p for p in place]
    w_grad = [Replicate() if p.is_replicate() else Partial() for p in place]
    fn = local_map(torch.matmul, out_placements=place,
                   in_placements=(place, w.placements),
                   in_grad_placements=(x_grad, w_grad), device_mesh=mesh)
    return fn(x, w)


def swiglu(x, w_gate, w_up, w_down):
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    return matmul(F.silu(g) * u, w_down)


def gelu_mlp(x, w1, b1, w2, b2):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(matmul(x, w1) + b1, approximate="tanh")
    return matmul(h, w2) + b2


# --------------------------------------------------------------------------
# ring attention (context parallelism)
# --------------------------------------------------------------------------

def combine_attention_partials(outs, lses):
    """Merge attention partials computed against disjoint KV shards.

    outs: list of (B,S,H,hd); lses: list of (B,S,H) log-sum-exp. The
    online-softmax identity: softmax over the union = exp-weighted
    combination of the partials. A partial whose keys are all masked
    for a row has lse ≈ -1e30 there and weight exp(-1e30 - m) = 0 beside
    any partial that has a key for it.
    """
    return _combine(outs, lses)[0]


def _combine(outs, lses):
    """:func:`combine_attention_partials`' output, and the log-sum-exp
    over the union of the partials' keys (fp32, (B,S,H))."""
    m = lses[0]
    for l in lses[1:]:
        m = torch.maximum(m, l)
    num = torch.zeros(outs[0].shape, dtype=torch.float32,
                      device=outs[0].device)
    den = torch.zeros(lses[0].shape, dtype=torch.float32,
                      device=lses[0].device)
    for o, l in zip(outs, lses):
        w = torch.exp(l - m)
        num = num + o.float() * w[..., None]
        den = den + w
    den = torch.clamp(den, min=1e-30)
    return (num / den[..., None]).to(outs[0].dtype), m + torch.log(den)


def attention_partial(q, k, v, q_pos, k_pos, causal=True, window=None,
                      block_q=512, block_kv=1024):
    """Flash attention returning (out, lse) for partial-KV combination:
    out (B,Sq,H,hd) in q's dtype and lse (B,Sq,H) in fp32, the
    reference's layout. A row with no key in this partial has out 0 and
    lse -1e30 (the reference averages the masked values there, at the
    same lse): either way it weighs nothing in
    :func:`combine_attention_partials`."""
    bq, bkv = min(block_q, q.shape[1]), min(block_kv, k.shape[1])
    n_rep = q.shape[2] // k.shape[2]
    pairs = _block_pairs(q_pos, k_pos, causal, window, bq, bkv)
    out, lse = _flash_fwd_impl(_heads(q, 1, bq), _heads(k, n_rep, bkv),
                               _heads(v, n_rep, bkv), q_pos, k_pos, causal,
                               window, bq, bkv, pairs)
    sq = q.shape[1]
    return out[:, :, :sq].transpose(1, 2), lse[:, :, :sq].transpose(1, 2)


def _rotate(tensors, group, to_rank: int, from_rank: int):
    """Start sending ``tensors`` to ``to_rank`` and receiving their like
    from ``from_rank`` (ranks of ``group``); returns the receive buffers
    and a ``wait()`` that also keeps the sent tensors alive till then."""
    got = [torch.empty_like(t) for t in tensors]
    to_rank = dist.get_global_rank(group, to_rank)
    from_rank = dist.get_global_rank(group, from_rank)
    ops = [dist.P2POp(dist.isend, t.contiguous(), to_rank, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, g, from_rank, group) for g in got]
    reqs = dist.batch_isend_irecv(ops)

    def wait():
        for r in reqs:
            r.wait()
        ops.clear()

    return got, wait


class _RingAttention(torch.autograd.Function):
    """The ring as one Function. Forward: a flash partial against each
    KV shard as it comes round, combined in step order. Backward: the
    reverse rotation — the KV shards travel round again with their
    gradients, each step's partial is recomputed against the combined
    lse (``_flash_bwd_impl``, as :class:`_FlashCore` does on one rank),
    dQ accumulates in place, and after n steps dK and dV are back on the
    rank that owns their shard. Each step's dK, dV of the query heads of
    a KV head are cast to k's dtype and added up head by head, as
    :class:`_FlashCore` adds them, then onto the travelling sum."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, group, causal, window, block_q,
                block_kv):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        cur = (k, v, k_pos)
        outs, lses = [], []
        for step in range(n):
            last = step == n - 1
            if not last:
                nxt, wait = _rotate(cur, group, (rank + 1) % n,
                                    (rank - 1) % n)
            out, lse = attention_partial(q, cur[0], cur[1], q_pos, cur[2],
                                         causal, window, block_q, block_kv)
            outs.append(out)
            lses.append(lse)
            if not last:
                wait()
                cur = tuple(nxt)
        out, lse = _combine(outs, lses)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.meta = (group, causal, window, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        group, causal, window, block_q, block_kv = ctx.meta
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        b, sq, h, hd = q.shape
        sk, kh = k.shape[1], k.shape[2]
        n_rep = h // kh
        bq, bkv = min(block_q, sq), min(block_kv, sk)
        qh, outh, douth = (_heads(t, 1, bq) for t in (q, out, dout))
        lseh = F.pad(lse.transpose(1, 2), (0, qh.shape[2] - sq))
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)

        def per_kv_head(g):      # the gradient of repeating K/V
            g = g.view(b, kh, n_rep, -1, hd)[:, :, :, :sk].to(k.dtype)
            total = g[:, :, 0]
            for r in range(1, n_rep):        # in k's dtype, head by head
                total = total + g[:, :, r]
            return total.transpose(1, 2)

        kc, vc, kpc = k, v, k_pos
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for step in range(n):
            pairs = _block_pairs(q_pos, kpc, causal, window, bq, bkv)
            gq, gk, gv = _flash_bwd_impl(
                qh, _heads(kc, n_rep, bkv), _heads(vc, n_rep, bkv), q_pos,
                kpc, outh, lseh, douth, causal, window, bq, bkv, pairs)
            dq.add_(gq)
            dk, dv = dk + per_kv_head(gk), dv + per_kv_head(gv)
            if n == 1:                   # gloo refuses a send to itself
                break
            # the shard goes on with its gradients; after the last step
            # only the gradients, to the rank that owns them
            last = step == n - 1
            got, wait = _rotate((dk, dv) if last else (kc, vc, kpc, dk, dv),
                                group, (rank + 1) % n, (rank - 1) % n)
            wait()
            if last:
                dk, dv = got
            else:
                kc, vc, kpc, dk, dv = got
        dq = dq[:, :, :sq].transpose(1, 2).to(q.dtype)
        return dq, dk, dv, None, None, None, None, None, None, None


def ring_attention(q, k, v, q_pos, k_pos, axis_name: str, causal=True,
                   window=None, block_q=512, block_kv=1024):
    """Context-parallel attention: sequence sharded over the mesh axis
    ``axis_name`` of the current mesh.

    The local view, like the reference's ``shard_map`` body: q, k, v are
    this rank's shards (B, S_loc, H|KH, hd) and q_pos/k_pos their
    absolute positions. Each of the ring's n steps computes a flash
    partial against the resident KV shard while the un-repeated K, V and
    k_pos travel on to the next rank (``batch_isend_irecv``, the
    reference's ``ppermute``); the n partials are combined in step
    order, as the reference's scan stacks them. The reference rotates
    once more after the last step and drops the result; the port does
    not send it, so a one-rank ring sends nothing (gloo refuses a send
    to its own rank; NCCL takes it).

    Differentiable, as ``jax.grad`` of the reference's ring is: the
    backward is :class:`_RingAttention`'s reverse rotation, n more
    transfers of K, V, k_pos and their gradients (none on one rank).
    """
    group = sharding.current_mesh().get_group(axis_name)
    return _RingAttention.apply(q, k, v, q_pos, k_pos, group, causal,
                                window, block_q, block_kv)
