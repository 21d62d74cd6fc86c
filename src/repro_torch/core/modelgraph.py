"""Layer-level model graph: the partitioner input to DistSim.

The paper leverages Megatron-LM's partitioner to obtain per-device
sub-models; we derive the same information directly from ``ArchConfig``:
a list of ``LayerSpec``s, each describing its GEMMs (full, unsharded
dims), parameter bytes, activation-output bytes and the collectives each
parallelism level induces. ``repro_torch.core.events`` shards these by the
strategy and deduplicates into events.

All byte counts assume bf16 (2 bytes) unless stated.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.configs.base import ArchConfig

BYTES = 2  # bf16


@dataclasses.dataclass(frozen=True)
class GEMM:
    m: int
    n: int
    k: int

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    @property
    def bytes(self) -> float:
        return BYTES * (self.m * self.k + self.k * self.n + self.m * self.n)

    def shard(self, mp: int, axis: str = "n") -> "GEMM":
        """Tensor-parallel sharding along n (column) or k (row) or m."""
        if mp == 1:
            return self
        if axis == "n":
            return GEMM(self.m, max(1, self.n // mp), self.k)
        if axis == "k":
            return GEMM(self.m, self.n, max(1, self.k // mp))
        return GEMM(max(1, self.m // mp), self.n, self.k)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str                    # e.g. "block", "embed", "head"
    kind: str                    # embed|attn_ffn|ssm|moe|head|enc_block|dec_block
    count: int                   # how many identical layers of this spec
    gemms: Tuple[GEMM, ...]      # forward GEMMs per microbatch (full dims)
    # (gemm, shard_axis) — which dim MP splits; len == len(gemms)
    shard_axes: Tuple[str, ...]
    param_bytes: float           # full (unsharded) parameter bytes
    act_bytes: float             # output activation bytes per microbatch
    # activation bytes all-reduced by TP per microbatch forward pass
    tp_allreduce_bytes: float = 0.0
    # bytes exchanged all-to-all by EP per microbatch forward pass
    ep_alltoall_bytes: float = 0.0
    mp_shardable: bool = True    # False → replicated under MP (e.g. norms)
    # decode scenario: persistent-state bytes (KV cache / SSM state)
    # streamed from HBM per forward pass — emitted as an ``hbm`` event
    kv_read_bytes: float = 0.0

    @property
    def fwd_flops(self) -> float:
        return sum(g.flops for g in self.gemms)

    @property
    def bwd_flops(self) -> float:
        return 2.0 * self.fwd_flops   # dgrad + wgrad


def _attn_gemms(cfg: ArchConfig, t: int, s: int, b: int,
                kv_len: Optional[int] = None):
    """Attention GEMMs for t=b*s query tokens against kv_len keys."""
    d, hd = cfg.d_model, cfg.head_dim
    kv = kv_len if kv_len is not None else s
    if cfg.sliding_window is not None:
        kv = min(kv, cfg.sliding_window)
    gemms = [
        GEMM(t, cfg.n_heads * hd, d),          # q proj   (col)
        GEMM(t, cfg.n_kv_heads * hd, d),       # k proj   (col)
        GEMM(t, cfg.n_kv_heads * hd, d),       # v proj   (col)
        GEMM(b * cfg.n_heads * s, kv, hd),     # scores   (head-sharded → m)
        GEMM(b * cfg.n_heads * s, hd, kv),     # att @ v  (head-sharded → m)
        GEMM(t, d, cfg.n_heads * hd),          # out proj (row)
    ]
    axes = ("n", "n", "n", "m", "m", "k")
    return gemms, axes


def _ffn_gemms(cfg: ArchConfig, t: int):
    d = cfg.d_model
    if cfg.moe is not None:
        e, k, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert
        te = int(t * k * cfg.moe.capacity_factor)   # routed tokens (total)
        gemms = [
            GEMM(t, e, d),                     # router (replicated)
            GEMM(te, f, d),                    # gate  (expert-sharded → m)
            GEMM(te, f, d),                    # up
            GEMM(te, d, f),                    # down
        ]
        axes = ("m", "m", "m", "m")            # EP shards routed tokens
        return gemms, axes
    if cfg.mlp_gelu:
        return [GEMM(t, cfg.d_ff, d), GEMM(t, d, cfg.d_ff)], ("n", "k")
    return ([GEMM(t, cfg.d_ff, d), GEMM(t, cfg.d_ff, d),
             GEMM(t, d, cfg.d_ff)], ("n", "n", "k"))


def _ssm_gemms(cfg: ArchConfig, t: int, b: int, s: int):
    d = cfg.d_model
    sc = cfg.ssm
    di = sc.expand * d
    n = sc.d_state
    nh = di // sc.head_dim
    q = min(sc.chunk, s)
    nc = max(1, s // q)
    gemms = [
        GEMM(t, 2 * di + 2 * n + nh, d),       # in_proj (col)
        GEMM(b * nc * q, q, n),                # C B^T scores
        GEMM(b * nc * q, di, q),               # Y_diag
        GEMM(b * nc * di, n, q),               # chunk states
        GEMM(b * nc * q, di, n),               # Y_off
        GEMM(t, d, di),                        # out_proj (row)
    ]
    axes = ("n", "m", "n", "m", "n", "k")
    return gemms, axes


def _block_params(cfg: ArchConfig):
    """dict(attn=, ffn_moe=, ffn_dense=, ssm=) parameter bytes per layer."""
    d, hd = cfg.d_model, cfg.head_dim if cfg.n_heads else 0
    attn = 0.0
    if cfg.n_heads:
        attn = BYTES * d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads
                                 + cfg.n_heads)
    ffn_moe = 0.0
    if cfg.moe is not None:
        f = cfg.moe.d_ff_expert
        ffn_moe = BYTES * (d * cfg.moe.n_experts
                           + cfg.moe.n_experts * 3 * d * f)
    if cfg.mlp_gelu:
        ffn_dense = BYTES * 2 * d * cfg.d_ff
    elif cfg.d_ff:
        ffn_dense = BYTES * 3 * d * cfg.d_ff
    else:
        ffn_dense = 0.0
    ssm = 0.0
    if cfg.ssm is not None:
        sc = cfg.ssm
        di = sc.expand * d
        nh = di // sc.head_dim
        ssm = BYTES * (d * (2 * di + 2 * sc.d_state + nh) + di * d
                       + sc.d_conv * (di + 2 * sc.d_state))
    return {"attn": attn, "ffn_moe": ffn_moe, "ffn_dense": ffn_dense,
            "ssm": ssm}


def _ffn_layer_bytes(cfg: ArchConfig, pb, active_only=False):
    """(moe_layer_ffn_bytes, dense_layer_ffn_bytes, n_moe, n_dense) totals."""
    if cfg.moe is None:
        return 0.0, pb["ffn_dense"], 0, cfg.n_layers
    n_moe = cfg.n_layers // cfg.moe_period
    n_dense = cfg.n_layers - n_moe
    moe_b = pb["ffn_moe"]
    if active_only:
        f = cfg.moe.d_ff_expert
        moe_b = BYTES * (cfg.d_model * cfg.moe.n_experts
                         + cfg.moe.top_k * 3 * cfg.d_model * f)
    return moe_b, pb["ffn_dense"], n_moe, n_dense


def build_graph(cfg: ArchConfig, batch: int, seq: int) -> List[LayerSpec]:
    """Layer graph for one microbatch of (batch, seq)."""
    t = batch * seq
    d = cfg.d_model
    act = BYTES * t * d
    pb = _block_params(cfg)
    attn_pb, ssm_pb = pb["attn"], pb["ssm"]
    ffn_pb = pb["ffn_moe"] if cfg.moe is not None else pb["ffn_dense"]
    layers: List[LayerSpec] = []

    emb_pb = BYTES * cfg.vocab * d
    layers.append(LayerSpec("embed", "embed", 1, (), (), emb_pb, act,
                            mp_shardable=False))

    ep_bytes = 0.0
    if cfg.moe is not None:
        # dispatch + combine of routed tokens
        ep_bytes = 2 * BYTES * t * cfg.moe.top_k * d

    if cfg.family == "ssm":
        g, a = _ssm_gemms(cfg, t, batch, seq)
        layers.append(LayerSpec("ssm_block", "ssm", cfg.n_layers, tuple(g), a,
                                ssm_pb, act, tp_allreduce_bytes=act))
    elif cfg.hybrid_period:
        n_attn = len(cfg.attn_layer_indices())
        moe_b, dense_b, n_moe, _ = _ffn_layer_bytes(cfg, pb)
        n_ssm_moe = max(0, n_moe - n_attn)     # attn layers take MoE slots
        n_ssm_dense = cfg.n_layers - n_attn - n_ssm_moe
        ga, aa = _attn_gemms(cfg, t, seq, batch)
        gf, af = _ffn_gemms(cfg, t)            # MoE ffn gemms
        layers.append(LayerSpec(
            "attn_block", "attn_ffn", n_attn, tuple(ga + gf), aa + af,
            attn_pb + moe_b, act, tp_allreduce_bytes=2 * act,
            ep_alltoall_bytes=ep_bytes))
        gs, as_ = _ssm_gemms(cfg, t, batch, seq)
        if n_ssm_moe:
            layers.append(LayerSpec(
                "ssm_moe_block", "ssm", n_ssm_moe, tuple(gs + gf), as_ + af,
                ssm_pb + moe_b, act, tp_allreduce_bytes=2 * act,
                ep_alltoall_bytes=ep_bytes))
        if n_ssm_dense:
            d_ff_gemms = ([GEMM(t, cfg.d_ff, d), GEMM(t, cfg.d_ff, d),
                           GEMM(t, d, cfg.d_ff)], ("n", "n", "k"))
            layers.append(LayerSpec(
                "ssm_dense_block", "ssm", n_ssm_dense,
                tuple(gs + d_ff_gemms[0]), as_ + d_ff_gemms[1],
                ssm_pb + dense_b, act, tp_allreduce_bytes=2 * act))
    elif cfg.enc_dec:
        ga, aa = _attn_gemms(cfg, t // 2, seq // 2, batch)
        gf, af = _ffn_gemms(cfg, t // 2)
        layers.append(LayerSpec(
            "enc_block", "attn_ffn", cfg.n_layers, tuple(ga + gf), aa + af,
            attn_pb + ffn_pb, act / 2, tp_allreduce_bytes=act))
        gc, ac = _attn_gemms(cfg, t // 2, seq // 2, batch, kv_len=seq // 2)
        layers.append(LayerSpec(
            "dec_block", "attn_ffn", cfg.n_layers,
            tuple(ga + gc + gf), aa + ac + af,
            2 * attn_pb + ffn_pb, act / 2, tp_allreduce_bytes=1.5 * act))
    else:
        ga, aa = _attn_gemms(cfg, t, seq, batch)
        gf, af = _ffn_gemms(cfg, t)
        layers.append(LayerSpec(
            "block", "attn_ffn", cfg.n_layers, tuple(ga + gf), aa + af,
            attn_pb + ffn_pb, act, tp_allreduce_bytes=2 * act,
            ep_alltoall_bytes=ep_bytes))

    head_pb = 0.0 if cfg.tie_embeddings else BYTES * d * cfg.vocab
    layers.append(LayerSpec("head", "head", 1,
                            (GEMM(t if not cfg.enc_dec else t // 2,
                                  cfg.vocab, d),),
                            ("n",), head_pb, BYTES * t * 4))
    return layers


# --------------------------------------------------------------------------
# decode scenario: seq=1 autoregressive graph + persistent-state memory
# --------------------------------------------------------------------------

def _kv_layer_bytes(cfg: ArchConfig, slots: int, kv_len: int) -> float:
    """KV-cache bytes one attention layer holds (and a decode step
    streams from HBM) for ``slots`` concurrent requests."""
    kv = kv_len
    if cfg.sliding_window is not None:
        kv = min(kv, cfg.sliding_window)
    return 2.0 * BYTES * slots * kv * cfg.n_kv_heads * cfg.head_dim


def _ssm_state_bytes(cfg: ArchConfig, slots: int) -> float:
    """Recurrent + conv state bytes per SSM layer (fp32 state)."""
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    return 4.0 * slots * (di * sc.d_state + sc.d_conv * (di + 2 * sc.d_state))


def _state_layer_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(attention layers holding KV cache, SSM layers holding state)."""
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.hybrid_period:
        n_attn = len(cfg.attn_layer_indices())
        return n_attn, cfg.n_layers - n_attn
    return cfg.n_layers, 0


def kv_cache_bytes(cfg: ArchConfig, slots: int, kv_len: int) -> float:
    """Total persistent decode state (KV cache + SSM state) across the
    whole model for ``slots`` concurrent requests at context ``kv_len``
    — the serving entry in the HBM memory model."""
    if cfg.enc_dec:
        raise ValueError("decode state model does not cover enc_dec models")
    n_attn, n_ssm = _state_layer_counts(cfg)
    total = n_attn * _kv_layer_bytes(cfg, slots, kv_len)
    if n_ssm:
        total += n_ssm * _ssm_state_bytes(cfg, slots)
    return total


def build_decode_graph(cfg: ArchConfig, slots: int, kv_len: int
                       ) -> List[LayerSpec]:
    """Layer graph for ONE autoregressive decode step: ``slots``
    concurrent requests, one query token each, attending to ``kv_len``
    cached keys. Each block carries ``kv_read_bytes`` — the HBM traffic
    of reading its KV cache / SSM state — which becomes an ``hbm``
    event in the composed stage."""
    if cfg.enc_dec:
        raise ValueError("decode scenario does not support enc_dec models")
    t = slots                       # one token per slot
    b = slots
    d = cfg.d_model
    act = BYTES * t * d
    pb = _block_params(cfg)
    attn_pb, ssm_pb = pb["attn"], pb["ssm"]
    ffn_pb = pb["ffn_moe"] if cfg.moe is not None else pb["ffn_dense"]
    layers: List[LayerSpec] = []

    emb_pb = BYTES * cfg.vocab * d
    layers.append(LayerSpec("embed", "embed", 1, (), (), emb_pb, act,
                            mp_shardable=False))

    ep_bytes = 0.0
    if cfg.moe is not None:
        ep_bytes = 2 * BYTES * t * cfg.moe.top_k * d

    if cfg.family == "ssm":
        g, a = _ssm_gemms(cfg, t, b, 1)
        layers.append(LayerSpec(
            "ssm_block", "ssm", cfg.n_layers, tuple(g), a, ssm_pb, act,
            tp_allreduce_bytes=act,
            kv_read_bytes=_ssm_state_bytes(cfg, slots)))
    elif cfg.hybrid_period:
        n_attn = len(cfg.attn_layer_indices())
        moe_b, dense_b, n_moe, _ = _ffn_layer_bytes(cfg, pb)
        n_ssm_moe = max(0, n_moe - n_attn)
        n_ssm_dense = cfg.n_layers - n_attn - n_ssm_moe
        kv_rd = _kv_layer_bytes(cfg, slots, kv_len)
        ssm_rd = _ssm_state_bytes(cfg, slots)
        ga, aa = _attn_gemms(cfg, t, 1, b, kv_len=kv_len)
        gf, af = _ffn_gemms(cfg, t)
        layers.append(LayerSpec(
            "attn_block", "attn_ffn", n_attn, tuple(ga + gf), aa + af,
            attn_pb + moe_b, act, tp_allreduce_bytes=2 * act,
            ep_alltoall_bytes=ep_bytes, kv_read_bytes=kv_rd))
        gs, as_ = _ssm_gemms(cfg, t, b, 1)
        if n_ssm_moe:
            layers.append(LayerSpec(
                "ssm_moe_block", "ssm", n_ssm_moe, tuple(gs + gf), as_ + af,
                ssm_pb + moe_b, act, tp_allreduce_bytes=2 * act,
                ep_alltoall_bytes=ep_bytes, kv_read_bytes=ssm_rd))
        if n_ssm_dense:
            d_ff_gemms = ([GEMM(t, cfg.d_ff, d), GEMM(t, cfg.d_ff, d),
                           GEMM(t, d, cfg.d_ff)], ("n", "n", "k"))
            layers.append(LayerSpec(
                "ssm_dense_block", "ssm", n_ssm_dense,
                tuple(gs + d_ff_gemms[0]), as_ + d_ff_gemms[1],
                ssm_pb + dense_b, act, tp_allreduce_bytes=2 * act,
                kv_read_bytes=ssm_rd))
    else:
        ga, aa = _attn_gemms(cfg, t, 1, b, kv_len=kv_len)
        gf, af = _ffn_gemms(cfg, t)
        layers.append(LayerSpec(
            "block", "attn_ffn", cfg.n_layers, tuple(ga + gf), aa + af,
            attn_pb + ffn_pb, act, tp_allreduce_bytes=2 * act,
            ep_alltoall_bytes=ep_bytes,
            kv_read_bytes=_kv_layer_bytes(cfg, slots, kv_len)))

    head_pb = 0.0 if cfg.tie_embeddings else BYTES * d * cfg.vocab
    layers.append(LayerSpec("head", "head", 1, (GEMM(t, cfg.vocab, d),),
                            ("n",), head_pb, BYTES * t * 4))
    return layers


# --------------------------------------------------------------------------
# parameter counting (used by ArchConfig.n_params and the roofline)
# --------------------------------------------------------------------------

def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    pb = _block_params(cfg)
    attn_pb, ssm_pb = pb["attn"], pb["ssm"]
    moe_b, dense_b, n_moe, n_dense = _ffn_layer_bytes(cfg, pb, active_only)
    total = 0.0
    if cfg.family == "ssm":
        total = ssm_pb * cfg.n_layers
    elif cfg.hybrid_period:
        n_attn = len(cfg.attn_layer_indices())
        n_ssm_moe = max(0, n_moe - n_attn)
        n_ssm_dense = cfg.n_layers - n_attn - n_ssm_moe
        total = (n_attn * (attn_pb + moe_b)
                 + n_ssm_moe * (ssm_pb + moe_b)
                 + n_ssm_dense * (ssm_pb + dense_b))
    elif cfg.enc_dec:
        ffn = moe_b if cfg.moe is not None else dense_b
        total = ((attn_pb + ffn) * cfg.n_layers
                 + (2 * attn_pb + ffn) * cfg.n_layers)
    else:
        total = n_moe * (attn_pb + moe_b) + n_dense * (attn_pb + dense_b)
    total += BYTES * cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        total += BYTES * cfg.d_model * cfg.vocab
    return int(total / BYTES)


def model_flops_per_token(cfg: ArchConfig) -> float:
    """The 6N approximation term (N = active params) for §Roofline."""
    return 6.0 * count_params(cfg, active_only=True)
