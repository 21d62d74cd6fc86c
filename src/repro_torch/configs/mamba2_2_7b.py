"""mamba2-2.7b [ssm] — attention-free, SSD (state-space duality).

64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]

long_500k INCLUDED: O(1)-state decode. Decode shapes use the recurrent SSD
step with a (B, nheads, head_dim, d_state) cache.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2_2_7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    d_ff=0,                     # SSD block replaces the FFN
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, chunk=256, expand=2),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2405.21060; unverified",
))
