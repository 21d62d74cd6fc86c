"""Every decode cell of the dry run's sweep (``decode_32k`` and
``long_500k``) on 16 x 16 at full width and 1 layer (jamba one period
of 8) under ``--baseline``, the paper-faithful mapping (no FSDP of the
serving weights), held to the reference's own dry run of the same cell
in the same mapping: FLOPs within 10 %, collective bytes at most 10 %
over (``tests/test_torch_dryrun_held.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

CELLS = held.cells("decode", "baseline")
reference = held.reference_fixture("baseline_decode", CELLS)


@pytest.mark.parametrize("arch,shape,layers", held.params(CELLS))
def test_baseline_decode_on_16x16_counts_the_references_work(
        reference, arch, shape, layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch,
                    ("baseline",))
