"""GPT-145B — the paper's large-scale generalization model (§5.5, Fig. 11).

Megatron-LM 145B configuration: 80L d_model=12288 96H d_ff=49152,
modeled with "8M16P1D" on 128 devices in the paper.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gpt_145b",
    family="dense",
    n_layers=80,
    d_model=12288,
    n_heads=96,
    n_kv_heads=96,
    d_ff=49152,
    vocab=51200,
    mlp_gelu=True,
    shapes=("train_4k",),
    source="Megatron-LM SC'21 145B (paper §5.5)",
))
