"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000
[arXiv:2401.16818; hf]

long_500k INCLUDED: SWA gives a bounded (4k) rolling KV cache, i.e.
sub-quadratic long-context decode (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o_danube_1_8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    rope_theta=1e4,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2401.16818; hf",
))
