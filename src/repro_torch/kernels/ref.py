"""Plain full-softmax oracles for the port's kernels (the allclose
targets of the tests), on tensors of any device."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal=True, window=None):
    """q,k,v: (BH, S, hd), contiguous positions; full-softmax reference."""
    sq, hd = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scale = hd ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def rmsnorm_ref(x, scale, eps=1e-6, psum=None, width=None):
    """x · rsqrt(mean(x²) + eps) · scale over the last dim, in fp32. With
    ``psum``, x holds this rank's columns of rows ``width`` wide, split
    over ranks: its sum of squares is summed over them by ``psum``."""
    xf = x.float()
    if psum is None:
        var = xf.square().mean(dim=-1, keepdim=True)
    else:
        var = psum(xf.square().sum(dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
