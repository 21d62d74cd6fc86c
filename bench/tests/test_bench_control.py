"""The control of the comparison: the reference put in the program's
place and computed in float8 (the precision below the configurations'
bf16) must come out as not correct. On the CPU at the tiny cells' size;
on the card at each cell's own size against its limits, and at
Qwen3-30B-A3B's published widths, where no cell has limits yet."""
import json
import math
import time

import pytest

from bench import control, harness

MANIFEST = harness.load_manifest()
FIXTURES = harness.BENCH / "tests" / "fixtures"
#: Qwen3-30B-A3B at its published widths and depth (head_dim 128, q/k
#: norms, 128 experts routed without a capacity), one 4096-token prompt
PUBLISHED = {"workloads": [{"name": "qwen3_moe_30b_a3b_published.prefill_4k",
                            "config": "qwen3_moe_30b_a3b_published",
                            "traffic": "prefill_4k", "chips": 1}],
             "end_to_end": [], "per_layer": []}


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


@pytest.mark.gpu
def test_the_control_reads_finite_at_qwen3_moes_published_widths(card):
    """The fp8 control against the fp32 reference, both a layer at a time
    on the card beside the 61 GB of bf16 weights: the upper readings the
    limits of a Qwen3-30B-A3B cell go under. Prints one line a seed with
    the readings, the seconds and the peak."""
    import torch
    c = harness.resolve(PUBLISHED, PUBLISHED["workloads"][0]["name"],
                        FIXTURES)
    for seed in (301, 302, 303):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        numbers = control.control_readings(c, seed, card)
        print(json.dumps({"seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t,
                          "peak": torch.cuda.max_memory_allocated()}))
        assert all(math.isfinite(v) for v in numbers.values()), numbers
