"""The port's data pipeline (``repro_torch.data.pipeline``, a copy of
the reference's numpy module with its imports rewritten): the data cases
of ``tests/test_train_substrate.py`` over both packages, and batches
bit-identical to the reference's, the loader's stub-modality inputs
included.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import smoke_config as ref_smoke_config
from repro.data import pipeline as ref_pipeline
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.data import pipeline

BOTH = pytest.mark.parametrize("m", [ref_pipeline, pipeline],
                               ids=["reference", "port"])


@BOTH
def test_data_deterministic_and_resumable(m):
    cfg = m.DataConfig(seed=5, vocab=100, seq_len=16, global_batch=4)
    b1 = m.synth_batch(cfg, 3)
    b2 = m.synth_batch(cfg, 3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    loader = m.DataLoader(cfg, start_step=3)
    step, batch = next(loader)
    loader.close()
    assert step == 3
    np.testing.assert_array_equal(batch["tokens"], b1["tokens"])


@BOTH
def test_data_shards_disjoint(m):
    c0 = m.DataConfig(seed=1, vocab=50, seq_len=8, global_batch=8,
                      shard_index=0, shard_count=2)
    c1 = dataclasses.replace(c0, shard_index=1)
    b0, b1 = m.synth_batch(c0, 0), m.synth_batch(c1, 0)
    assert b0["tokens"].shape == (4, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


@BOTH
def test_labels_shifted(m):
    cfg = m.DataConfig(seed=2, vocab=100, seq_len=16, global_batch=2)
    b = m.synth_batch(cfg, 0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (7, 123, 1),
                                             (3, 2 ** 20, 0)])
def test_batches_are_the_references_bits(seed, step, shard):
    kw = dict(seed=seed, vocab=32000, seq_len=64, global_batch=4,
              shard_index=shard, shard_count=2)
    want = ref_pipeline.synth_batch(ref_pipeline.DataConfig(**kw), step)
    got = pipeline.synth_batch(pipeline.DataConfig(**kw), step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "qwen2_vl_72b",
                                  "whisper_tiny", "t5_large"])
def test_loader_batches_are_the_references_bits(arch):
    """Three loader steps from step 5 per package: tokens, labels and
    the stub-modality inputs (patch embeddings for the VLM, frame
    embeddings or reversed encoder tokens for enc-dec configs)."""
    ref_cfg, cfg = ref_smoke_config(ref_get_config(arch)), \
        smoke_config(get_config(arch))
    kw = dict(seed=11, vocab=cfg.vocab, seq_len=32, global_batch=2)
    loaders = [ref_pipeline.DataLoader(ref_pipeline.DataConfig(**kw), 5,
                                       arch=ref_cfg),
               pipeline.DataLoader(pipeline.DataConfig(**kw), 5, arch=cfg)]
    try:
        for _ in range(3):
            (sa, want), (sb, got) = next(loaders[0]), next(loaders[1])
            assert sa == sb
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        for loader in loaders:
            loader.close()
