"""Architecture/config system.

``ArchConfig`` is the single source of truth: in this package
``repro_torch.core.modelgraph`` builds the DistSim layer graph (events)
from it; the executable model and the launch tooling, once ported, read
the same fields.

All assigned architectures are registered here via their config modules; use
``get_config(name)`` / ``list_archs()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int           # per-expert hidden size
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128          # N in SSD
    head_dim: int = 64          # P in SSD
    chunk: int = 256            # SSD chunk length
    d_conv: int = 4             # depthwise conv width
    expand: int = 2             # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell assigned to an architecture."""
    name: str                   # train_4k / prefill_32k / decode_32k / long_500k
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four LM shapes shared by all assigned architectures.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free
    n_kv_heads: int
    d_ff: int                   # dense FFN hidden (0 for attn-free SSD blocks)
    vocab: int
    # --- options ---
    qkv_bias: bool = False
    mlp_gelu: bool = False                    # 2-matrix GELU MLP (BERT/GPT-2 era)
    sliding_window: Optional[int] = None      # SWA width (tokens)
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    enc_dec: bool = False                     # whisper-style encoder-decoder
    vision_stub: bool = False                 # VLM: patch-embedding input stub
    audio_stub: bool = False                  # audio: frame-embedding input stub
    moe: Optional[MoEConfig] = None
    # MoE applied to every `moe_period`-th FFN (1 = all layers; jamba = 2)
    moe_period: int = 1
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): one attention layer per `hybrid_period` layers, the rest SSM
    hybrid_period: int = 0
    # which assigned shapes apply (None = all); long_500k must be explicitly
    # included (sub-quadratic archs only).
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    # citation / provenance string from the assignment table
    source: str = ""

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.n_heads == 0

    def attn_layer_indices(self) -> Tuple[int, ...]:
        """Indices of attention layers (hybrid archs interleave)."""
        if self.is_attention_free:
            return ()
        if self.hybrid_period:
            # jamba: 1 attention layer per period, at position period//2
            off = self.hybrid_period // 2
            return tuple(i for i in range(self.n_layers)
                         if i % self.hybrid_period == off)
        return tuple(range(self.n_layers))

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        from repro_torch.core.modelgraph import count_params
        return count_params(self)

    def n_active_params(self) -> int:
        from repro_torch.core.modelgraph import count_params
        return count_params(self, active_only=True)


_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


_ASSIGNED = (
    "whisper_tiny", "qwen2_1_5b", "h2o_danube_1_8b", "mistral_large_123b",
    "phi3_medium_14b", "mamba2_2_7b", "qwen3_moe_30b_a3b", "dbrx_132b",
    "qwen2_vl_72b", "jamba_v0_1_52b",
)
_PAPER = ("bert_large", "gpt2_345m", "t5_large", "bert_exlarge", "gpt_145b")


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    for mod in _ASSIGNED + _PAPER:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_archs(assigned_only: bool = False) -> Tuple[str, ...]:
    _ensure_loaded()
    return _ASSIGNED if assigned_only else tuple(sorted(_REGISTRY))


def arch_shapes(cfg: ArchConfig):
    """The ShapeConfigs that apply to this architecture."""
    return [SHAPES[s] for s in cfg.shapes]


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests."""
    moe = None
    if cfg.moe:
        moe = MoEConfig(n_experts=min(4, cfg.moe.n_experts),
                        top_k=min(2, cfg.moe.top_k), d_ff_expert=64)
    ssm = None
    if cfg.ssm:
        ssm = SSMConfig(d_state=16, head_dim=16, chunk=32, expand=2)
    n_layers = 4 if cfg.hybrid_period else 2
    n_heads = 0 if cfg.is_attention_free else 4
    n_kv = 0 if cfg.is_attention_free else min(cfg.n_kv_heads, 2)
    return dataclasses.replace(
        cfg, name=cfg.name + "_smoke", n_layers=n_layers, d_model=64,
        n_heads=n_heads, n_kv_heads=n_kv, d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256, sliding_window=32 if cfg.sliding_window else None,
        moe=moe, ssm=ssm, hybrid_period=2 if cfg.hybrid_period else 0,
    )
