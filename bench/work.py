"""The work a cell needs, counted from its shapes alone.

Every count here is reckoned from the configuration file and the traffic
mix, never from what the program runs, so a metric built on it reads
the same whatever the program does to get there. The peaks are NVIDIA's
published figures for one H100 SXM (dense, no sparsity, at its 700 W
limit).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: bf16 tensor-core peak of one H100 SXM, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM, bytes/s
PEAK_HBM_BYTES = 3.35e12


def head_dim(cfg: dict) -> int:
    """The width of each query and KV head: the file's ``head_dim``,
    else ``d_model // n_heads``."""
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def attended_pairs(s_q: int, s_k: int, causal: bool,
                   window: Optional[int]) -> int:
    """(query, key) pairs of one sequence that the masks keep: query ``i``
    and key ``j`` at positions ``i`` and ``j`` (aligned at 0), kept when
    ``j <= i`` (causal) and ``i - j < window``."""
    q = np.arange(s_q, dtype=np.int64)
    lo = np.zeros_like(q) if window is None else np.maximum(q - window + 1, 0)
    hi = np.minimum(q, s_k - 1) if causal else np.full_like(q, s_k - 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_flops(cfg: dict, batch: int, seq: int,
                    backward: bool = False) -> float:
    """FLOPs of one layer's attention over ``batch`` sequences of ``seq``
    tokens: QKᵀ and PV over the kept pairs, 2 FLOPs a multiply-add, so
    4·B·Hq·P·d forward; the backward's dQ, dK, dV and dP, 8·B·Hq·P·d,
    with no recompute."""
    pairs = attended_pairs(seq, seq, True, cfg.get("sliding_window"))
    per = 8 if backward else 4
    return float(per * batch * cfg["n_heads"] * pairs * head_dim(cfg))


def attention_bytes(cfg: dict, batch: int, seq: int, itemsize: int = 2,
                    backward: bool = False) -> float:
    """Bytes of one layer's attention, each tensor read or written once:
    q, k, v, o forward; q, k, v, o, dO read and dQ, dK, dV written
    backward."""
    d = head_dim(cfg)
    q = batch * seq * cfg["n_heads"] * d
    kv = batch * seq * cfg["n_kv_heads"] * d
    n = (3 * q + 3 * kv) if backward else (2 * q + 2 * kv)
    return float(n * itemsize)


def roofline_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def matmul_params(cfg: dict, active: bool = False) -> int:
    """Parameters that multiply activations in a matmul: the attention
    projections, the dense FFN or the router and the experts (with
    ``active``, the ``top_k`` a token runs), and the untied head. The
    embedding is a gather and is not counted."""
    d, hd = cfg["d_model"], head_dim(cfg)
    attn = 2 * d * cfg["n_heads"] * hd + 2 * d * cfg["n_kv_heads"] * hd
    moe = cfg.get("moe")
    if moe:
        experts = moe["top_k"] if active else moe["n_experts"]
        ffn = d * moe["n_experts"] + experts * 3 * d * moe["d_ff_expert"]
    else:
        ffn = 3 * d * cfg["d_ff"]
    head = 0 if cfg.get("tie_embeddings") else d * cfg["vocab"]
    return cfg["n_layers"] * (attn + ffn) + head


def moe_flops(cfg: dict, batch: int, seq: int) -> float:
    """FLOPs of one MoE layer over ``batch`` sequences of ``seq`` tokens,
    T tokens in all: the router's product and each token's ``top_k``
    SwiGLU experts (three products of d × f each), 2 FLOPs a
    multiply-add, so 2·T·(d·E + k·3·d·f). A per-layer reader of the MoE
    span divides this, with :func:`moe_bytes`, by the span's device
    time (:func:`roofline_seconds`)."""
    moe, d, t = cfg["moe"], cfg["d_model"], batch * seq
    return float(2 * t * (d * moe["n_experts"]
                          + moe["top_k"] * 3 * d * moe["d_ff_expert"]))


def moe_bytes(cfg: dict, batch: int, seq: int, itemsize: int = 2) -> float:
    """Bytes of one MoE layer over T = ``batch`` · ``seq`` tokens, each
    read or written once: the weights of the ``min(E, T·k)`` experts
    that T tokens can reach, the router's, and the T rows of d in and
    out. A per-layer reader of the MoE span divides this, with
    :func:`moe_flops`, by the span's device time."""
    moe, d, t = cfg["moe"], cfg["d_model"], batch * seq
    experts = min(moe["n_experts"], t * moe["top_k"])
    n = experts * 3 * d * moe["d_ff_expert"] + d * moe["n_experts"] \
        + 2 * t * d
    return float(n * itemsize)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6·N·T over the matmul
    parameters (forward and backward once each, recompute not counted)
    plus every layer's attention forward and backward."""
    tokens = batch * seq
    attn = attention_flops(cfg, batch, seq) + attention_flops(
        cfg, batch, seq, backward=True)
    return 6.0 * matmul_params(cfg, active=True) * tokens \
        + cfg["n_layers"] * attn


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill: 2·N_active·T (the head on every
    position, whose logits the prefill returns) plus every layer's
    attention forward."""
    return 2.0 * matmul_params(cfg, active=True) * batch * seq \
        + cfg["n_layers"] * attention_flops(cfg, batch, seq)
