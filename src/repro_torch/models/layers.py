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
parameter tree is used as it is. The sharding constraints are no-ops
until sharding is ported; ``attention_partial``,
``combine_attention_partials`` and ``ring_attention`` come with context
parallelism (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import rmsnorm_ref

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Runtime (non-architectural) knobs."""
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"          # auto | naive | flash_torch | cuda
    block_q: int = 512
    block_kv: int = 1024
    remat: bool = True               # activation checkpointing per layer
    # sequence threshold above which "auto" switches naive → flash_torch
    flash_threshold: int = 2048


def constrain(x: torch.Tensor, opts: ModelOptions) -> torch.Tensor:
    """Residual-stream sharding constraint: a no-op until sharding is
    ported."""
    return x


def constrain_qkv(x: torch.Tensor, opts: ModelOptions,
                  is_kv: bool = False) -> torch.Tensor:
    """Attention-layout sharding constraint: a no-op until sharding is
    ported."""
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


def _dots(a, b):
    """``a·bᵀ`` over the last two dims: (..., Q, hd) x (..., K, hd) →
    (..., Q, K) in fp32, the reference's ``preferred_element_type=
    float32`` (bf16 products are exact in fp32 and summed in fp32). bf16
    on the card runs on the tensor cores with an fp32 output; everything
    else is upcast to an fp32 GEMM (no TF32 unless the process allows
    it)."""
    lead, q, k = a.shape[:-2], a.shape[-2], b.shape[-2]
    a3 = a.reshape(-1, q, a.shape[-1])
    b3 = b.reshape(-1, k, b.shape[-1]).transpose(1, 2)
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
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
    never skipped while one entry survives; one copy to the host."""
    big = 2 ** 62
    qp = _blockify(q_pos.long(), block_q, pad_value=-1).flatten(1)
    kp = _blockify(k_pos.long(), block_kv, pad_value=2 ** 30).flatten(1)
    qv, kv = qp >= 0, kp < 2 ** 29
    nq, nk = qp.shape[0], kp.shape[0]
    flat = torch.cat([qp.masked_fill(~qv, big).amin(1), qp.amax(1),
                      qv.all(1).long(), kp.amin(1),
                      kp.masked_fill(~kv, -big).amax(1),
                      kv.all(1).long()]).tolist()
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
    query head, in fp32 and that layout. The softmax scale multiplies
    the small dq, dk products instead of the score-sized ds."""
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
            ds = _dots(doblk, vblk).sub_(delta[:, :, qs, None]).mul_(p)
            ds = ds.to(q.dtype)
            dq[i].add_(ds @ kblk, alpha=scale)
            dk.add_(ds.transpose(-1, -2) @ qblk, alpha=scale)
        dks.append(dk)
        dvs.append(dv)
    return (torch.cat(dq, dim=2), torch.cat(dks, dim=2),
            torch.cat(dvs, dim=2))


class _FlashCore(torch.autograd.Function):
    """The reference's ``custom_vjp`` around ``_flash_core`` as one
    Function: the blockwise forward, and a backward that recomputes p
    block by block from what it saved — q (in its head-major layout),
    the un-repeated k and v, out and lse. The backward repeats K/V again
    and sums each KV head's dk, dv over its query heads in fp32 before
    the cast to k's dtype."""

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
            return g.view(b, kh, n_rep, -1, hd)[:, :, :, :sk].sum(dim=2) \
                .transpose(1, 2).to(k.dtype)

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


def attention_decode(q, k_cache, v_cache, q_pos, k_pos, window=None):
    """Single-step decode attention.

    q: (B,1,H,hd); caches: (B,S,KH,hd); k_pos: (B,S) absolute positions of
    cache slots (2**30 marks empty slots — they mask out via causality).
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
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v_cache)
    return out.reshape(b, 1, kh * n_rep, hd)


def attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
              opts: ModelOptions = DEFAULT_OPTIONS):
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


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def gelu_mlp(x, w1, b1, w2, b2):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ w1 + b1, approximate="tanh")
    return h @ w2 + b2
