"""Train cells under ``--mapping fsdp_cp`` on the multi-pod mesh,
2 x 16 x 16 with axes ``("pod", "data", "model")``, at full width and 1
layer: h2o (grouped KV heads, the flash scans), qwen2_vl (its stream
split along the sequence), qwen3_moe (the MoE's capacity slots over 512
ranks) and mamba2 (the SSM, no attention), held to the reference's own
dry run of the same cell, mesh and mapping: no-skip FLOPs within 10 %
once the stated causes are out, collective bytes at most 10 % over
(``tests/test_torch_dryrun_held.py``; the batch's 32 shards over
``("pod", "data")``). The other multi-pod cells are tabled by
``python tests/test_torch_dryrun_held.py --multi --fsdp_cp train``.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

CELLS = held.fsdp_cp_cells("multipod")
reference = held.reference_fixture("fsdp_cp_multipod", CELLS)


@pytest.mark.parametrize("arch,shape,layers", held.params(CELLS))
def test_fsdp_cp_multipod_train_counts_the_references_work(
        reference, arch, shape, layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch,
                    ("multi", "fsdp_cp"))
