"""Core transformer layers in PyTorch: the forward half of the reference
package's ``repro.models.layers``.

Attention has three implementations selectable via
``ModelOptions.attn_impl``:

  * ``naive``       — materializes (B,H,S,S) scores. Reference semantics.
  * ``flash_torch`` — blockwise online softmax in plain PyTorch (the
                      reference's ``flash_jnp`` forward); O(block_q x
                      block_kv) live scores.
  * ``cuda``        — the hand-written Hopper kernel behind
                      ``repro_torch.kernels.ops.flash_attention`` (the
                      reference's ``pallas``); on CPU tensors its plain
                      version.

``auto`` chooses as the reference does: naive up to ``flash_threshold``
keys, ``flash_torch`` above, never the kernel.

Weights keep the reference's (in, out) layout, so a converted reference
parameter tree is used as it is. The sharding constraints are no-ops
until sharding is ported; the flash backward, ``attention_partial``,
``combine_attention_partials`` and ``ring_attention`` come with training
and context parallelism (ROADMAP.md, Queue 1).
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


def _scores(q, k, scale):
    """(B,Q,H,hd) x (B,K,H,hd) → (B,H,Q,K) in fp32: bf16 products are
    exact in fp32, so this is the reference's
    ``preferred_element_type=float32``."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def attention_naive(q, k, v, q_pos, k_pos, causal=True, window=None):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KH,hd). Returns (B,Sq,H,hd)."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    logits = _scores(q, k, q.shape[-1] ** -0.5)
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


def _flash_fwd_impl(q, k, v, q_pos, k_pos, causal, window,
                    block_q, block_kv):
    """Returns (out (B,Sq,H,hd), lse (B,Sq,H)). KV already head-repeated."""
    b, sq, h, hd = q.shape
    scale = hd ** -0.5
    qb = _blockify(q, block_q)
    qposb = _blockify(q_pos, block_q, pad_value=-1)
    kb = _blockify(k, block_kv)
    vb = _blockify(v, block_kv)
    kposb = _blockify(k_pos, block_kv, pad_value=2 ** 30)

    outs, lses = [], []
    for qblk, qpblk in zip(qb, qposb):                   # (B,bq,H,hd),(B,bq)
        m = torch.full((b, h, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, block_q, hd), dtype=torch.float32,
                          device=q.device)
        for kblk, vblk, kpblk in zip(kb, vb, kposb):
            logits = _scores(qblk, kblk, scale)
            msk = _causal_window_mask(qpblk, kpblk, causal, window)
            msk &= (kpblk < 2 ** 29)[:, None, :] & (qpblk >= 0)[:, :, None]
            logits = torch.where(msk[:, None], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qblk.dtype), vblk).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        lse = m + torch.log(torch.clamp(l, min=1e-30))     # (B,H,bq)
        outs.append(out.transpose(1, 2).to(q.dtype))       # (B,bq,H,hd)
        lses.append(lse.transpose(1, 2))                   # (B,bq,H)
    out = torch.cat(outs, dim=1)[:, :sq]
    lse = torch.cat(lses, dim=1)[:, :sq]
    return out, lse


def attention_flash_torch(q, k, v, q_pos, k_pos, causal=True, window=None,
                          block_q=512, block_kv=1024):
    """Blockwise (FlashAttention-style) online-softmax attention in plain
    PyTorch, forward only: O(block_q x block_kv) live scores."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    out, _ = _flash_fwd_impl(q, k, v, q_pos, k_pos, causal, window,
                             min(block_q, q.shape[1]),
                             min(block_kv, k.shape[1]))
    return out


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
