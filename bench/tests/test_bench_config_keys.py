"""A configuration file's optional keys: ``head_dim``, ``qk_norm`` and
``moe.capacity_factor`` null, as the weights and the port's config read
them. A file that leaves them out means what it meant before; the
reference's reading of them is in ``test_bench_reference.py``."""
import dataclasses

import pytest
import torch

from bench import harness, traffic, weights
from bench.reference import decoder

FIXTURES = harness.BENCH / "tests" / "fixtures" / "configs"


def config(name):
    return harness.read_json(FIXTURES / f"{name}.json")


def with_derived_head_dim(cfg):
    return dict(cfg, head_dim=cfg["d_model"] // cfg["n_heads"])


def equal_trees(a, b):
    pa, pb = list(weights.paths(a)), list(weights.paths(b))
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


@pytest.mark.parametrize("name", ["tiny_dense", "tiny_moe"])
def test_a_stated_derived_head_dim_draws_the_same_weights(name):
    cfg = config(name)
    assert weights.shapes(with_derived_head_dim(cfg)) == weights.shapes(cfg)
    assert equal_trees(weights.make(with_derived_head_dim(cfg), 41, "cpu"),
                       weights.make(cfg, 41, "cpu"))


@pytest.mark.parametrize("name", ["tiny_dense", "tiny_moe"])
def test_a_stated_derived_head_dim_gives_the_same_logits(name):
    cfg = config(name)
    w = weights.make(cfg, 42, "cpu")
    tokens = traffic.pool({"kind": "prefill", "batch": 2, "seq_len": 40,
                           "pool": 1}, cfg, 42, "cpu")[0]["tokens"]
    assert torch.equal(
        decoder.forward(with_derived_head_dim(cfg), w, tokens),
        decoder.forward(cfg, w, tokens))


@pytest.mark.parametrize("name", ["tiny_dense", "tiny_moe"])
def test_a_stated_derived_head_dim_gives_the_same_loss_and_grads(name):
    cfg = config(name)
    w = weights.make(cfg, 43, "cpu")
    batch = traffic.pool({"kind": "train", "batch": 2, "seq_len": 40,
                          "pool": 1}, cfg, 43, "cpu")[0]
    loss, grads = decoder.loss_and_grads(with_derived_head_dim(cfg), w,
                                         batch)
    want_loss, want_grads = decoder.loss_and_grads(cfg, w, batch)
    assert torch.equal(loss, want_loss)
    assert equal_trees(grads, want_grads)


def test_the_qwen3_layout_has_wide_heads_and_qk_norm_scales():
    cfg = config("tiny_qwen3")
    layer = weights.shapes(cfg)["attn_layers"]
    assert (layer["wq"], layer["wk"], layer["wv"], layer["wo"]) == (
        (2, 64, 128), (2, 64, 64), (2, 64, 64), (2, 128, 64))
    assert layer["ln_q"] == layer["ln_k"] == (2, 32)
    w = weights.make(cfg, 44, "cpu")["attn_layers"]
    for name in ("ln_q", "ln_k"):
        assert torch.equal(w[name], torch.ones(2, 32, dtype=torch.bfloat16))
    # the norm scales are the only leaves added: every other path stays
    others = {p for p, _ in weights.paths(weights.shapes(cfg))
              if not p.endswith(("ln_q", "ln_k"))}
    assert others == {p for p, _ in weights.paths(weights.shapes(
        config("tiny_moe")))}


#: the fields :func:`harness.port_fields` sets, with defaults
FIELDS = [("n_layers", int, 0), ("d_model", int, 0), ("n_heads", int, 0),
          ("n_kv_heads", int, 0), ("d_ff", int, 0), ("vocab", int, 0),
          ("sliding_window", object, None), ("rope_theta", float, 0.0),
          ("qkv_bias", bool, False), ("tie_embeddings", bool, False),
          ("moe", object, None)]


def stand_in(*extra):
    """A frozen config class with the port's fields and ``extra``: a
    stand-in for an ``ArchConfig`` that has (or lacks) the new fields."""
    extra_fields = {"head_dim": ("head_dim", int, 0),
                    "qk_norm": ("qk_norm", bool, False)}
    cls = dataclasses.make_dataclass(
        "StandIn", [(n, t, dataclasses.field(default=d))
                    for n, t, d in FIELDS] + [extra_fields[e]
                                              for e in extra],
        frozen=True)
    return cls()


def test_port_config_passes_the_three_keys():
    cfg = config("tiny_qwen3")
    arch = harness.port_config(cfg, stand_in("head_dim", "qk_norm"))
    assert arch.head_dim == 32 and arch.qk_norm is True
    assert arch.moe.capacity_factor is None
    assert (arch.moe.n_experts, arch.moe.top_k, arch.moe.d_ff_expert) == (
        8, 2, 32)
    assert (arch.n_heads, arch.n_kv_heads, arch.d_model) == (4, 2, 64)


def test_port_config_leaves_unstated_keys_alone():
    arch = harness.port_config(config("tiny_moe"),
                               stand_in("head_dim", "qk_norm"))
    assert arch.head_dim == 0 and arch.qk_norm is False
    assert arch.moe.capacity_factor == 1.25


@pytest.mark.parametrize("missing", ["head_dim", "qk_norm"])
def test_port_config_refuses_a_key_the_port_does_not_take(missing):
    kept = [k for k in ("head_dim", "qk_norm") if k != missing]
    with pytest.raises(ValueError, match=missing):
        harness.port_config(config("tiny_qwen3"), stand_in(*kept))
