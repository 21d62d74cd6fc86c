"""The dry run's cells that once failed to lower, each traced here on
the production meshes over a fake process group (256 ranks; 512 for the
multi-pod case), full width at a depth cut, through
``repro_torch.launch.dryrun.lower_cell``:

* every MoE decode and ``--baseline`` MoE cell, whose FFN takes
  ``moe_impl="gather"`` on DTensors (the combine of the experts' rows);
* whisper_tiny's decode, whose 6 heads do not divide the 16 ``model``
  ranks (the cross-attention's q gathered, its K/V cache split over the
  sequence);
* t5_large's train step, one attention head a rank (the attention's
  gradients handed back to DTensor contiguous);
* jamba's decode and long-context cells (the SSM decode step on
  DTensors);
* the smoke qwen2 ``prefill_32k`` cell on both meshes ("tiny weights on
  256 ranks").

Each must lower, with its three roofline terms and its peak bytes per
device above 0. Every cell of the sweep on 16 x 16 (these among them)
is held to the reference's own dry run of the same cell by
``tests/test_torch_dryrun_held_{train,prefill,decode}.py``. The whole
sweep over every architecture (40 cells a mesh) is ``python -m
repro_torch.launch.dryrun --layers 2 --device cpu`` per architecture
(jamba ``--layers 8``), which takes minutes a mesh.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun as D

#: (arch, shape, --baseline, smoke config, layers): one layer (jamba one
#: period of 8) at full width, unless smoke
FAILED_CELLS = {
    "dbrx_132b-decode_32k": ("dbrx_132b", "decode_32k", False, False, 1),
    "qwen3_moe_30b_a3b-decode_32k": ("qwen3_moe_30b_a3b", "decode_32k",
                                     False, False, 1),
    "jamba_v0_1_52b-decode_32k": ("jamba_v0_1_52b", "decode_32k", False,
                                  False, 8),
    "jamba_v0_1_52b-long_500k": ("jamba_v0_1_52b", "long_500k", False,
                                 False, 8),
    "whisper_tiny-decode_32k": ("whisper_tiny", "decode_32k", False, False,
                                1),
    "t5_large-train_4k": ("t5_large", "train_4k", False, False, 1),
    "qwen2_1_5b-smoke-prefill_32k": ("qwen2_1_5b", "prefill_32k", False,
                                     True, 1),
}
#: every cell on both meshes, and dbrx's --baseline prefill on 16 x 16
CELLS = [pytest.param(arch, shape, multi, base, smoke, layers,
                      id=f"{name}-{'2x16x16' if multi else '16x16'}")
         for name, (arch, shape, base, smoke, layers) in FAILED_CELLS.items()
         for multi in (False, True)] + [
    pytest.param("dbrx_132b", "prefill_32k", False, True, False, 1,
                 id="dbrx_132b-prefill_32k-baseline-16x16")]


@pytest.mark.parametrize("arch,shape,multi_pod,baseline,smoke,layers",
                         CELLS)
def test_the_cell_lowers(arch, shape, multi_pod, baseline, smoke, layers):
    rep, mem = D.lower_cell(arch, shape, multi_pod, baseline, device="cpu",
                            smoke=smoke, layers=layers)
    assert rep.n_chips == (512 if multi_pod else 256)
    terms = (rep.t_compute, rep.t_memory, rep.t_collective)
    assert all(t > 0 for t in terms), terms
    assert mem["peak_bytes_per_device"] > 0
