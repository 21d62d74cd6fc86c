"""Every prefill cell of the dry run's sweep (``prefill_32k``) on
16 x 16 at full width and 1 layer (jamba one period of 8) under
``--baseline``, the paper-faithful mapping, held to the reference's own
dry run of the same cell in the same mapping: no-skip FLOPs within
10 %, collective bytes at most 10 % over
(``tests/test_torch_dryrun_held.py``). Heads that ``model`` does not
divide (qwen2's 12, phi3's 40, whisper's 6) are split over the
gcd(heads, 16) groups of consecutive ranks and repeated within a group,
as XLA splits them; h2o's, qwen2's and phi3's cells did not lower
before (DTensor's product of a sequence split over ``model`` by the
row-parallel ``w_down``).
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

CELLS = held.cells("prefill", "baseline")
reference = held.reference_fixture("baseline_prefill", CELLS)


@pytest.mark.parametrize("arch,shape,layers", held.params(CELLS))
def test_baseline_prefill_on_16x16_counts_the_references_work(
        reference, arch, shape, layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch,
                    ("baseline",))
