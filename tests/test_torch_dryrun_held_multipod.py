"""Cells of the dry run's sweep on the multi-pod mesh, 2 x 16 x 16 with
axes ``("pod", "data", "model")``, at full width and 1 layer (jamba one
period of 8), held to the reference's own dry run of the same cell on
the same mesh: no-skip FLOPs within 10 %, collective bytes at most 10 %
over (``tests/test_torch_dryrun_held.py``; the batch's 32 shards over
``("pod", "data")``). At least one cell a hand-split path of the port,
each taking the three-dimensional batch axis: the vocab-parallel
cross-entropy and heads padded over ``model`` (qwen2 train), the head's
rows (gpt2 train, held to its cause), ``ep_a2a`` (qwen3_moe train),
attention on padded heads (phi3 prefill), the SSM step on its placed
cache (mamba2 decode), ``_seq_reduce`` over flattened dimensions (h2o
long_500k), the hybrid's dense FFN split over ``model`` (jamba prefill,
held to its cause), the MoE's and the enc-dec's decode (dbrx, whisper),
t5's one head a rank, and the hybrid's decode (jamba: the reference
repeats its dense FFN over ``pod``, held to its cause).
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

CELLS = [(a, s, held.layers_of(a), "multi") for a, s in (
    ("qwen2_1_5b", "train_4k"), ("gpt2_345m", "train_4k"),
    ("qwen3_moe_30b_a3b", "train_4k"), ("t5_large", "train_4k"),
    ("phi3_medium_14b", "prefill_32k"), ("jamba_v0_1_52b", "prefill_32k"),
    ("mamba2_2_7b", "decode_32k"), ("h2o_danube_1_8b", "long_500k"),
    ("dbrx_132b", "decode_32k"), ("whisper_tiny", "decode_32k"),
    ("jamba_v0_1_52b", "decode_32k"))]
reference = held.reference_fixture("multipod", CELLS)


@pytest.mark.parametrize("arch,shape,layers", held.params(CELLS))
def test_multipod_cell_counts_the_references_work(reference, arch, shape,
                                                  layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch,
                    ("multi",))
