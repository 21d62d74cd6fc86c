"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution; BACKBONE only here.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
[arXiv:2409.12191; hf]

Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (batch, 1024, d_model) prepended to text-token embeddings.
M-RoPE realized as standard RoPE on the flattened sequence (DESIGN.md §4).
long_500k skipped: full attention.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2_vl_72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    vision_stub=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2409.12191; hf",
))

# number of stub patch-embedding positions prepended to the text sequence
N_PATCHES = 1024
