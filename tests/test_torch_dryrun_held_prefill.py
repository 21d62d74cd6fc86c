"""Every prefill cell of the dry run's sweep (``prefill_32k``) on
16 x 16 at full width and 1 layer (jamba one period of 8), held to the
reference's own dry run of the same cell: no-skip FLOPs within 10 %,
collective bytes at most 10 % over (``tests/test_torch_dryrun_held.py``
has the bars and the stated causes). Heads that ``model`` does not
divide are padded as XLA pads them (phi3's 40, qwen2's 12, whisper's 6)
and the hybrid's dense FFN is split over ``model``.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

reference = held.reference_fixture("prefill")


@pytest.mark.parametrize("arch,shape,layers",
                         held.params(held.file_cells("prefill")))
def test_prefill_on_16x16_counts_the_references_work(reference, arch, shape,
                                                     layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch)
