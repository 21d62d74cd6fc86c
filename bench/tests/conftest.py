"""The benchmark's tests: ``python -m pytest bench/tests`` from the
checkout's root. Tests that need the card carry the ``gpu`` marker and
decide inside the ``card`` fixture whether there is one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
#: the CPU cells: tiny configurations of the two families at the
#: benchmark's traffic kinds (prefill at one length and at a cycle of
#: lengths), with limits of their own
TINY = {"workloads": [
    {"name": "tiny_dense.train", "config": "tiny_dense",
     "traffic": "tiny_train", "chips": 1},
    {"name": "tiny_moe.prefill", "config": "tiny_moe",
     "traffic": "tiny_prefill", "chips": 1},
    {"name": "tiny_dense.prefill_mixed", "config": "tiny_dense",
     "traffic": "tiny_mixed", "chips": 1}],
    "end_to_end": [], "per_layer": []}


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def tiny():
    """``tiny(name)``: a CPU cell of :data:`TINY`."""
    from bench import harness
    return lambda name: harness.resolve(TINY, name, FIXTURES)
