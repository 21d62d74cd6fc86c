"""GPT-2-345M — paper evaluation model (Fig. 8/9). [Radford et al. 2019]

24L d_model=1024 16H d_ff=4096 vocab=50257.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gpt2_345m",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=50257,
    qkv_bias=True,
    mlp_gelu=True,
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="GPT-2 (paper eval model)",
))
