"""whisper-tiny [audio] — enc-dec transformer backbone, conv frontend stubbed.

4L d_model=384 6H (GQA kv=6 == MHA) d_ff=1536 vocab=51865
[arXiv:2212.04356; unverified]

Shapes: enc-dec; decode shapes drive the decoder with a cached encoder
output. long_500k skipped (full attention).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper_tiny",
    family="audio",
    n_layers=4,                # 4 encoder + 4 decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    qkv_bias=True,
    mlp_gelu=True,
    enc_dec=True,
    audio_stub=True,           # input_specs() provides frame embeddings
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="arXiv:2212.04356; unverified",
))
