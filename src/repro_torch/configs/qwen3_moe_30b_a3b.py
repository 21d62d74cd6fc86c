"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, fine-grained d_ff.

48L d_model=2048 32H (GQA kv=4) d_ff=768(per-expert) vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf]

long_500k skipped: full attention (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen3_moe_30b_a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                   # per-expert hidden (fine-grained)
    vocab=151936,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
