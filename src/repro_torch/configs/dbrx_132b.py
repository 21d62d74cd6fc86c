"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752(per-expert) vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified]

long_500k skipped: full attention (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="dbrx_132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="hf:databricks/dbrx-base; unverified",
))
