"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified]

long_500k skipped: pure full attention (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3_medium_14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    rope_theta=1e4,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2404.14219; unverified",
))
