"""Every train cell of the dry run's sweep (``train_4k``: the ten
assigned architectures and the five of the paper, jamba at one period
of 8 layers) on 16 x 16 at full width and 1 layer under ``--baseline``,
the paper-faithful mapping (no residual-stream or head spec, no FSDP,
no ZeRO-1, the MoE under ``gather``), held to the reference's own dry
run of the same cell in the same mapping: no-skip FLOPs within 10 %,
collective bytes at most 10 % over (``tests/test_torch_dryrun_held.py``
has the bars and the stated causes). With no spec to place them, the
port multiplies the tensor-parallel weights where ``param_specs`` put
them, as XLA does: Megatron's column- then row-parallel products, each
block's output all-reduced and its input's gradient too, attention on
each rank's heads (``lm._attn_on_column_shards``), and the MoE's tokens
gathered into each rank's experts' slots by hand
(``moe._dispatch_on_shards``).
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_held as held

CELLS = held.cells("train", "baseline")
reference = held.reference_fixture("baseline_train", CELLS)


@pytest.mark.parametrize("arch,shape,layers", held.params(CELLS))
def test_baseline_train_on_16x16_counts_the_references_work(
        reference, arch, shape, layers, monkeypatch):
    held.check_cell(reference, arch, shape, layers, monkeypatch,
                    ("baseline",))
