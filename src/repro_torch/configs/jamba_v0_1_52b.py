"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

long_500k INCLUDED (hybrid): attention KV caches sharded over the `data`
mesh axis (sequence parallelism); SSM layers carry O(1) state.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    moe_period=2,               # MoE on every other layer (16 of 32)
    ssm=SSMConfig(d_state=16, head_dim=64, chunk=256, expand=2),
    hybrid_period=8,            # 1 attention layer per 8 (1:7 attn:mamba)
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2403.19887; hf",
))
