"""The dense train cells of the dry run's sweep (``train_4k``: bert_large
and bert_exlarge as one, gpt2, gpt_145b, h2o, mistral, phi3, qwen2 and
the VLM qwen2_vl) on 16 x 16 at full width and 1 layer under
``--mapping fsdp_cp`` (no tensor parallelism, the sequence over
``model``, ZeRO-3 over both axes), held to the reference's own dry run
of the same cell in the same mapping: no-skip FLOPs within 10 % once
the stated causes are out, collective bytes at most 10 % over
(``tests/test_torch_dryrun_held.py``). Each cell's gap is held exactly
to its causes (``held.fsdp_cp_causes``): the head's rows (every cell but
qwen2_vl, whose vocabulary the reference splits over every rank) and the
flash scans that the reference's XLA runs whole on every rank of
``model`` (``held.CP_ATTENTION``). qwen2_vl's stream starts split along
the sequence (``lm.start_stream``), its projections on each rank's
positions.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

CELLS = held.fsdp_cp_cells("dense")
reference = held.reference_fixture("fsdp_cp_dense", CELLS)


@pytest.mark.parametrize("arch,shape,layers", held.params(CELLS))
def test_fsdp_cp_dense_train_on_16x16_counts_the_references_work(
        reference, arch, shape, layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch,
                    ("fsdp_cp",))
