"""T5-Large — paper evaluation model (Fig. 8/9). [arXiv:1910.10683]

24L (12 enc + 12 dec modeled as n_layers=12 enc-dec pairs) d_model=1024
16H d_ff=4096 vocab=32128. Encoder-decoder.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="t5_large",
    family="dense",
    n_layers=12,               # 12 encoder + 12 decoder layers (enc_dec pairs)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=32128,
    mlp_gelu=True,
    enc_dec=True,
    tie_embeddings=True,
    shapes=("train_4k",),
    source="arXiv:1910.10683 (paper eval model)",
))
