"""Mamba2 SSD (state-space duality) block in PyTorch: the port of the
reference package's ``repro.models.ssm``.

Training/prefill uses the chunked SSD algorithm (arXiv:2405.21060
listing 1): an intra-chunk dual (quadratic in the chunk, matmul-heavy)
plus an inter-chunk linear recurrence. Decode uses the O(1) recurrent
step on a (B, H, P, N) state cache. Single B/C group (G=1); head layout
d_inner = expand·d_model = H·P.

The reference is plain JAX (no Pallas kernel), so the port is plain
PyTorch on every device. Where the two differ in form, the values are
the reference's:

* ``lax.conv_general_dilated`` with ``feature_group_count=C`` and left
  padding K−1 is ``F.conv1d(groups=C)`` on the input padded on the left
  only, the weight (K, C) laid out as (C, 1, K);
* the ``lax.scan`` over chunks is a loop that emits the state *before*
  each chunk;
* the fp32 casts stay where the reference has them, and so does the
  rounding of ``x · dt`` to x's dtype;
* each three-operand einsum runs as two contractions, so no
  (b, c, h, q, s, p) intermediate is formed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.parallel.sharding import gather_dim, is_dtensor


def ssm_dims(d_model: int, scfg: SSMConfig):
    d_inner = scfg.expand * d_model
    n_heads = d_inner // scfg.head_dim
    return d_inner, n_heads


def ssm_params_shape(d_model: int, scfg: SSMConfig):
    d_inner, n_heads = ssm_dims(d_model, scfg)
    conv_ch = d_inner + 2 * scfg.d_state
    return {
        "in_proj": (d_model, 2 * d_inner + 2 * scfg.d_state + n_heads),
        "conv_w": (scfg.d_conv, conv_ch),
        "conv_b": (conv_ch,),
        "dt_bias": (n_heads,),
        "A_log": (n_heads,),
        "D": (n_heads,),
        "norm_scale": (d_inner,),
        "out_proj": (d_inner, d_model),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) → (..., Q, Q) with S[i,j] = sum_{k=j+1..i} x_k, -inf
    for i < j."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, s, -torch.inf)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,L,C), w: (K,C)."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))               # (B,C,K-1+L)
    out = F.conv1d(xp, w.T[:, None, :].to(x.dtype), groups=c)
    return out.transpose(1, 2) + b.to(x.dtype)


def ssd_chunked(x, dt, A, B_mat, C_mat, chunk: int):
    """Chunked SSD scan.

    x: (B,L,H,P); dt: (B,L,H) (post-softplus); A: (H,) negative;
    B_mat/C_mat: (B,L,N). Returns (B,L,H,P) and final state (B,H,P,N).
    """
    b, l, h, p = x.shape
    n = B_mat.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, pad))
    nc = x.shape[1] // q

    f32 = torch.float32
    xb = (x * dt[..., None].to(x.dtype)).reshape(b, nc, q, h, p)
    xb = xb.to(f32).permute(0, 1, 3, 2, 4)                     # (B,nc,H,Q,P)
    Bc = B_mat.reshape(b, nc, q, n).to(f32)
    Cc = C_mat.reshape(b, nc, q, n).to(f32)
    dA = (dt.to(f32) * A.to(f32)).reshape(b, nc, q, h)
    dA = dA.permute(0, 1, 3, 2)                                # (B,nc,H,Q)
    dA_cs = torch.cumsum(dA, dim=-1)

    # intra-chunk (dual / quadratic) term: (scores ∘ L) then · x
    L = torch.exp(_segsum(dA))                                 # (B,nc,H,Q,Q)
    scores = Cc @ Bc.transpose(-1, -2)                         # (B,nc,Q,S)
    Y_diag = (scores[:, :, None] * L) @ xb                     # (B,nc,H,Q,P)
    del L

    # per-chunk input → state contribution: (decay ∘ x)ᵀ · B
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)          # (B,nc,H,Q)
    states = (xb * decay_states[..., None]).transpose(-1, -2) \
        @ Bc[:, :, None]                                       # (B,nc,H,P,N)

    # inter-chunk recurrence over nc chunks, emitting the state BEFORE
    # each chunk
    chunk_decay = torch.exp(dA_cs[..., -1])                    # (B,nc,H)
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (B,nc,H,P,N)

    # inter-chunk (off-diagonal) output term: (C · stateᵀ) ∘ decay
    state_decay = torch.exp(dA_cs)                             # (B,nc,H,Q)
    Y_off = (Cc[:, :, None] @ prev_states.transpose(-1, -2)) \
        * state_decay[..., None]                               # (B,nc,H,Q,P)

    y = (Y_diag + Y_off).permute(0, 1, 3, 2, 4).reshape(b, nc * q, h, p)
    return y[:, :l].to(x.dtype), state


class SSMCache(NamedTuple):
    conv: torch.Tensor     # (B, d_conv-1, conv_channels)
    state: torch.Tensor    # (B, H, P, N) float32


def init_ssm_cache(batch: int, d_model: int, scfg: SSMConfig,
                   dtype=torch.bfloat16, device=None) -> SSMCache:
    d_inner, n_heads = ssm_dims(d_model, scfg)
    conv_ch = d_inner + 2 * scfg.d_state
    return SSMCache(
        conv=torch.zeros((batch, scfg.d_conv - 1, conv_ch), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, n_heads, scfg.head_dim, scfg.d_state),
                          dtype=torch.float32, device=device))


def _split_xbc(xbc, d_inner, d_state):
    x = xbc[..., :d_inner]
    B_mat = xbc[..., d_inner:d_inner + d_state]
    C_mat = xbc[..., d_inner + d_state:]
    return x, B_mat, C_mat


def head_shard(params, d_model: int, scfg: SSMConfig, rank: int,
               n_ranks: int):
    """The block's weights of the heads rank ``rank`` of ``n_ranks``
    holds, when the block is split over heads (``n_ranks`` divides the
    heads): their columns of z, x and dt and all of B and C from
    ``in_proj``, their conv channels of x and all of B and C, their
    ``dt_bias``, ``A_log``, ``D`` and ``norm_scale`` entries and their
    rows of ``out_proj``. Slices of the whole weights, so their
    gradients land in the whole weights' places."""
    d_inner, n_heads = ssm_dims(d_model, scfg)
    n, hl = scfg.d_state, n_heads // n_ranks
    h0, c0, cl = rank * hl, rank * hl * scfg.head_dim, hl * scfg.head_dim
    w, cw, cb = params["in_proj"], params["conv_w"], params["conv_b"]
    bc = slice(2 * d_inner, 2 * d_inner + 2 * n)
    return {
        "in_proj": torch.cat([w[:, c0:c0 + cl],
                              w[:, d_inner + c0:d_inner + c0 + cl],
                              w[:, bc],
                              w[:, bc.stop + h0:bc.stop + h0 + hl]], 1),
        "conv_w": torch.cat([cw[:, c0:c0 + cl], cw[:, d_inner:]], 1),
        "conv_b": torch.cat([cb[c0:c0 + cl], cb[d_inner:]]),
        "dt_bias": params["dt_bias"][h0:h0 + hl],
        "A_log": params["A_log"][h0:h0 + hl],
        "D": params["D"][h0:h0 + hl],
        "norm_scale": params["norm_scale"][c0:c0 + cl],
        "out_proj": params["out_proj"][c0:c0 + cl],
    }


def ssm_block(x_in: torch.Tensor, params, scfg: SSMConfig,
              psum=None) -> torch.Tensor:
    """Full Mamba2 block forward. x_in: (B,L,d) → (B,L,d).

    The head count is ``params``'s: given :func:`head_shard`'s weights
    it runs those heads, and the result is this rank's share of the
    output (its rows of ``out_proj``), to be summed over the ranks;
    ``psum(t)`` then sums ``t`` over them for the gated norm."""
    from repro_torch.models.layers import rmsnorm
    b, l, d = x_in.shape
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * scfg.head_dim
    n = scfg.d_state

    proj = x_in @ params["in_proj"]
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * n]
    dt = proj[..., -n_heads:]

    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, B_mat, C_mat = _split_xbc(xbc, d_inner, n)
    xs = xs.reshape(b, l, n_heads, scfg.head_dim)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    y, _ = ssd_chunked(xs, dt, A, B_mat, C_mat, scfg.chunk)
    y = y + xs * params["D"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(b, l, d_inner)
    y = rmsnorm(y * F.silu(z), params["norm_scale"], psum=psum,
                width=ssm_dims(d, scfg)[0])
    return y @ params["out_proj"]


def ssm_block_decode(x_in: torch.Tensor, params, scfg: SSMConfig,
                     cache: SSMCache):
    """Single-token recurrent step. x_in: (B,1,d) → (B,1,d), new
    cache."""
    from repro_torch.models.layers import rmsnorm
    b, _, d = x_in.shape
    d_inner, n_heads = ssm_dims(d, scfg)
    n = scfg.d_state
    p = scfg.head_dim

    proj = (x_in @ params["in_proj"])[:, 0]                      # (B,E)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * n]
    dt = proj[..., -n_heads:]

    # rolling conv state
    win = torch.cat([cache.conv, xbc[:, None, :]], dim=1)        # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", win.float(),
                            params["conv_w"].float())
    xbc = F.silu(conv_out + params["conv_b"].float()).to(x_in.dtype)
    new_conv = win[:, 1:]

    xs, B_mat, C_mat = _split_xbc(xbc, d_inner, n)
    xs = xs.reshape(b, n_heads, p)
    dt = F.softplus(dt.float() + params["dt_bias"].float())      # (B,H)
    A = -torch.exp(params["A_log"].float())

    decay = torch.exp(dt * A)                                    # (B,H)
    upd = (dt[..., None] * xs.float())[..., None] \
        * B_mat.float()[:, None, None, :]                        # (B,H,P,N)
    h_new = cache.state * decay[..., None, None] + upd
    if is_dtensor(h_new):
        # The decode step runs on DTensors as DTensor places it, the
        # state's heads split over `model` as cache_specs splits them
        # (a step is one token a sequence: no split by hand is worth
        # its collectives). DTensor cannot propagate a fold of a split
        # dimension with another: the contraction over N is a product
        # and a sum (the same values, summed in another order), and y,
        # (B, H, P), has its heads and head columns gathered before it
        # is flattened.
        y = (h_new * C_mat.float()[:, None, None, :]).sum(-1)
    else:
        y = torch.einsum("bhpn,bn->bhp", h_new, C_mat.float())
    y = y.to(xs.dtype) + xs * params["D"].to(xs.dtype)[None, :, None]
    y = gather_dim(gather_dim(y, 1), 2).reshape(b, d_inner)
    y = rmsnorm((y * F.silu(z))[:, None, :], params["norm_scale"])
    out = y @ params["out_proj"]
    return out, SSMCache(conv=new_conv, state=h_new)
