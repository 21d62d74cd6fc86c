"""The MoE, SSM, hybrid and enc-dec train cells of the dry run's sweep
(``train_4k``: dbrx, qwen3_moe, jamba at one period of 8 layers, mamba2,
t5 and whisper) on 16 x 16 at full width under ``--mapping fsdp_cp``
(no tensor parallelism, the sequence over ``model``, ZeRO-3 over both
axes), held to the reference's own dry run of the same cell in the same
mapping: no-skip FLOPs within 10 % once the stated causes are out,
collective bytes at most 10 % over (``tests/test_torch_dryrun_held.py``;
the causes in ``held.fsdp_cp_causes``: the head's rows, the flash scans
and the MoE's router, which the reference runs on the tokens of ``data``
alone). The MoE lowers through ``moe._gather_on_slots``: each rank's
tokens routed, every expert's whole queue formed, the capacity slots
split over the ranks; whisper's encoder stream starts split along the
sequence (``lm.start_stream``).
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

CELLS = held.fsdp_cp_cells("families")
reference = held.reference_fixture("fsdp_cp_families", CELLS)


@pytest.mark.parametrize("arch,shape,layers", held.params(CELLS))
def test_fsdp_cp_family_train_on_16x16_counts_the_references_work(
        reference, arch, shape, layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch,
                    ("fsdp_cp",))
