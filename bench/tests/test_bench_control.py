"""The control of the comparison: the reference put in the program's
place and computed in float8 (the precision below the configurations'
bf16) must come out as not correct. On the CPU at the tiny cells' size;
on the card at each cell's own size against its limits."""
import pytest

from bench import control, harness

MANIFEST = harness.load_manifest()


def fails(cell, numbers) -> bool:
    return any(cell.limits[k] is not None and v > cell.limits[k]
               for k, v in numbers.items())


@pytest.mark.parametrize("cell", ["tiny_dense.train", "tiny_moe.prefill",
                                  "tiny_dense.prefill_mixed"])
def test_the_control_fails_at_the_tiny_size(tiny, cell):
    c = tiny(cell)
    for seed in (200, 201, 202):
        assert fails(c, control.control_readings(c, seed, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_the_control_fails_at_the_cells_size(card, cell):
    c = harness.resolve(MANIFEST, cell)
    for seed in (301, 302, 303):
        assert fails(c, control.control_readings(c, seed, card))
