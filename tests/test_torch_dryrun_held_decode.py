"""Every decode cell of the dry run's sweep (``decode_32k`` and
``long_500k``) on 16 x 16 at full width and 1 layer (jamba one period
of 8), held to the reference's own dry run of the same cell: FLOPs
within 10 % (no block pair is skipped in decode), collective bytes at
most 10 % over (``tests/test_torch_dryrun_held.py``). Among them the
MoE's experts placed by hand and its combine a pending sum of the
tokens' rows (dbrx, qwen3_moe), whisper's cross-attention on a cache
split over the sequence, and the SSM step computed where ``cache_specs``
placed the cache (mamba2, jamba). And jamba's train cell (one period of
8 layers), the costliest to lower, which balances the three files.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

reference = held.reference_fixture("decode")


@pytest.mark.parametrize("arch,shape,layers",
                         held.params(held.cells("decode")))
def test_decode_on_16x16_counts_the_references_work(reference, arch, shape,
                                                    layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch)


@pytest.mark.parametrize("arch,shape,layers", held.params([held.MOVED]))
def test_train_on_16x16_counts_the_references_work(reference, arch, shape,
                                                   layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch)
