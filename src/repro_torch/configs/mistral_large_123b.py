"""mistral-large-123b [dense].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]

long_500k skipped: pure full attention (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral_large_123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    rope_theta=1e6,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
))
