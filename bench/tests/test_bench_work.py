"""The work counted from shapes (``bench/work.py``)."""
import pytest
import torch

from bench import harness, weights, work


def brute_pairs(s_q, s_k, causal, window):
    i = torch.arange(s_q)[:, None]
    j = torch.arange(s_k)[None, :]
    keep = torch.ones(s_q, s_k, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= i - j < window
    return int(keep.sum())


@pytest.mark.parametrize("s_q,s_k", [(1, 1), (7, 7), (64, 64), (33, 50),
                                     (50, 33)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 5, 16, 100])
def test_pairs_equal_a_brute_force_mask(s_q, s_k, causal, window):
    assert work.attended_pairs(s_q, s_k, causal, window) == brute_pairs(
        s_q, s_k, causal, window)


def config(name):
    """A configuration of the benchmark, or else a test fixture's."""
    path = harness.BENCH / "configs" / f"{name}.json"
    if not path.exists():
        path = harness.BENCH / "tests" / "fixtures" / "configs" / f"{name}.json"
    return harness.read_json(path)


def test_h2o_windowed_attention_at_2x8192_is_the_k2_bound():
    """4·B·Hq·P·d for B=2 × 8192 under h2o's 4096-token window:
    5.154e11 FLOPs a layer, the bound of PERF.md's kernels table
    (0.5212 ms at 989 TFLOP/s)."""
    flops = work.attention_flops(config("h2o_danube_1_8b"), 2, 8192)
    assert flops == 4 * 2 * 32 * 25_167_872 * 80
    assert flops / 989e12 * 1e3 == pytest.approx(0.5211708984428716,
                                                 rel=1e-12)


def test_step_work_of_the_two_cells():
    h2o = config("h2o_danube_1_8b")
    assert work.train_step_flops(h2o, 2, 4096) == pytest.approx(9.84e13,
                                                                rel=5e-3)
    # 2 x 1.749e9 matmul parameters x 4096 tokens, plus 24 layers of
    # 4 x 32 heads x 8 390 656 causal pairs x 80
    assert work.prefill_flops(h2o, 1, 4096) == pytest.approx(
        2 * 1_749_155_840 * 4096 + 24 * 4 * 32 * 8_390_656 * 80, rel=1e-12)
    per_layer = work.attention_flops(h2o, 2, 4096) + work.attention_flops(
        h2o, 2, 4096, backward=True)
    assert 24 * per_layer / 989e12 == pytest.approx(0.0125, rel=1e-2)


@pytest.mark.parametrize("name", ["h2o_danube_1_8b", "tiny_moe",
                                  "tiny_qwen3",
                                  "qwen3_moe_30b_a3b_published"])
def test_matmul_parameters_are_the_weights_but_the_embedding(name):
    cfg = config(name)
    total = sum(int(torch.Size(s).numel()) for p, s in
                weights.paths(weights.shapes(cfg))
                if p != "embed" and not p.rsplit(".", 1)[-1].startswith(
                    ("ln", "b", "final_norm")))
    router = 0
    if cfg.get("moe"):
        router = cfg["n_layers"] * cfg["d_model"] * cfg["moe"]["n_experts"]
    assert work.matmul_params(cfg) == total
    if cfg.get("moe"):
        m = cfg["moe"]
        idle = m["n_experts"] - m["top_k"]
        assert work.matmul_params(cfg, active=True) == total - cfg[
            "n_layers"] * idle * 3 * cfg["d_model"] * m["d_ff_expert"]
        assert router > 0


def test_the_roofline_takes_the_larger_bound():
    assert work.roofline_seconds(989e12, 1.0) == (1.0, "operations")
    t, which = work.roofline_seconds(1.0, 3.35e12)
    assert (t, which) == (1.0, "bytes")


def test_h2o_counts_are_the_literal_values():
    """The counts of h2o's cells, which the optional keys must not move."""
    h2o = config("h2o_danube_1_8b")
    assert work.head_dim(h2o) == 80
    assert work.matmul_params(h2o) == 1_749_155_840
    assert work.train_step_flops(h2o, 2, 4096) == 98_347_033_559_040
    assert work.prefill_flops(h2o, 1, 4096) == 16_391_172_259_840
    assert work.attention_flops(h2o, 1, 4096) == 85_920_317_440
    assert work.attention_bytes(h2o, 1, 4096) == 52_428_800


def test_qwen3_counts_at_the_published_widths():
    """Qwen3-30B-A3B as published: head_dim 128 (not 2048 / 32), 128
    experts of width 768, 8 a token; one 4096-token prefill."""
    q = config("qwen3_moe_30b_a3b_published")
    assert work.head_dim(q) == 128
    assert work.matmul_params(q, active=True) == 3_041_656_832
    assert work.prefill_flops(q, 1, 4096) == 31_515_933_147_136
    assert work.attention_flops(q, 1, 4096) == 137_472_507_904
    assert work.attention_bytes(q, 1, 4096) == 75_497_472
    assert work.moe_flops(q, 1, 4096) == 311_385_128_960
    assert work.moe_bytes(q, 1, 4096) == 1_242_038_272
    assert sum(int(torch.Size(s).numel()) for _, s in weights.paths(
        weights.shapes(q))) == 30_532_122_624
    # bound by bytes, near the ridge: 0.315 ms of operations, 0.371 of bytes
    t, which = work.roofline_seconds(work.moe_flops(q, 1, 4096),
                                     work.moe_bytes(q, 1, 4096))
    assert which == "bytes" and t == pytest.approx(3.7076e-4, rel=1e-4)


@pytest.mark.parametrize("batch,seq", [(1, 1), (1, 3), (2, 64)])
def test_moe_work_is_the_expert_layers_weights_and_rows(batch, seq):
    """One MoE layer's FLOPs are 2 a multiply-add of the router and the
    top_k experts on every token; its bytes the weights of the experts
    the tokens can reach (all 8 once T·k >= 8), the router and the
    rows."""
    cfg = config("tiny_qwen3")
    m, d, t = cfg["moe"], cfg["d_model"], batch * seq
    ffn = {p: int(torch.Size(s[1:]).numel()) for p, s in weights.paths(
        weights.shapes(cfg)) if p.startswith("attn_layers.ffn.")}
    experts = ffn["attn_layers.ffn.w_gate"] + ffn["attn_layers.ffn.w_up"] \
        + ffn["attn_layers.ffn.w_down"]
    router = ffn["attn_layers.ffn.router"]
    assert work.moe_flops(cfg, batch, seq) == 2 * t * (
        router + m["top_k"] * experts // m["n_experts"])
    reach = min(m["n_experts"], t * m["top_k"])
    assert work.moe_bytes(cfg, batch, seq, itemsize=4) == 4 * (
        experts * reach // m["n_experts"] + router + 2 * t * d)
