"""BERT-Large — paper evaluation model (Fig. 3/8/9/10). [arXiv:1810.04805]

24L d_model=1024 16H d_ff=4096 vocab=30522. Encoder-only (no decode shapes).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="bert_large",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=30522,
    qkv_bias=True,
    mlp_gelu=True,
    shapes=("train_4k",),
    source="arXiv:1810.04805 (paper eval model)",
))
