"""With the timed path broken underneath, a run's ``correct`` comes out
false, once for each fault a cell can have (``bench/faults.py``); the
sound run comes out true. On the CPU, at the tiny cells' sizes and
limits (``fixtures/limits``); the look for a chip is skipped by calling
the traffic driver itself."""
import pytest

from bench import faults, harness

CELLS = {"tiny_dense.train": ("train", 2), "tiny_moe.prefill": ("prefill", 2),
         "tiny_dense.prefill_mixed": ("prefill", 1)}
#: a batch of one row has no half to leave out
CASES = [(cell, name) for cell, (kind, rows) in CELLS.items()
         for name in faults.BY_KIND[kind]
         if name != "half_batch" or rows > 1]


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_sound_run_is_correct(tiny, cell):
    c = tiny(cell)
    for seed in (11, 12):
        out = harness.kind_module(c).run(c, seed, 0.05, False, "cpu", 0.0)
        assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_makes_the_run_incorrect(tiny, cell, fault):
    c = tiny(cell)
    out = harness.kind_module(c).run(c, 13, 0.05, False, "cpu", 0.0,
                                     fault=faults.BY_KIND[c.kind][fault])
    assert out["correct"] is False, out["checks"]
