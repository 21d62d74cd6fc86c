"""BERT-exLarge — the paper's unseen 48-layer strategy-search model (§6).

48 transformer layers; other dims follow BERT-Large scaling (d_model=1024).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="bert_exlarge",
    family="dense",
    n_layers=48,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=30522,
    qkv_bias=True,
    mlp_gelu=True,
    shapes=("train_4k",),
    source="paper §6 strategy-search model",
))
