"""Every train cell of the dry run's sweep (``train_4k``, the ten
assigned architectures and the five of the paper) on 16 x 16 at full
width and 1 layer, held to the reference's own dry run of the same cell:
no-skip FLOPs within 10 %, collective bytes at most 10 % over
(``tests/test_torch_dryrun_held.py`` has the bars and the stated
causes). jamba's (one period of 8 layers) is held by
``tests/test_torch_dryrun_held_decode.py``, to balance the files. Megatron's vocab-parallel cross-entropy, heads padded to
the mesh and the collectives of a layer kept under remat are what bring
the train cells there.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

reference = held.reference_fixture("train")


@pytest.mark.parametrize("arch,shape,layers",
                         held.params(held.file_cells("train")))
def test_train_on_16x16_counts_the_references_work(reference, arch, shape,
                                                   layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch)
