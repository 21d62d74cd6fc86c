"""Public wrappers around the port's kernels, in the reference
package's calling conventions (``repro.kernels.ops``).

``flash_attention`` matches ``repro_torch.models.layers.attention``'s
convention ((B,S,H,hd) GQA layout + position arrays) so the model can
select ``attn_impl="cuda"``. CUDA tensors go to the hand-written
kernels, CPU tensors to their plain versions.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal=True,
                    window=None, block_q=128, block_kv=128):
    """q: (B,S,H,hd); k,v: (B,S,KH,hd) GQA. Positions must be
    contiguous 0..S-1 for q and k alike: they are not read (the kernel
    derives them from row indices)."""
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=block_q, block_kv=block_kv)


def rmsnorm(x, scale, eps=1e-6, block_rows=128):
    """x: (..., d); scale: (d,)."""
    return rn.rmsnorm(x, scale, eps=eps, block_rows=block_rows)
