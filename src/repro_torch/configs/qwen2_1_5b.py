"""qwen2-1.5b [dense] — GQA with QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2407.10671; hf]

long_500k skipped: pure full attention (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2_1_5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2407.10671; hf",
))
