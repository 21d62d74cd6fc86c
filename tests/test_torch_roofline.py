"""The port's roofline module against the reference's: the HLO-text
analyser over both packages (equal dicts, equal report rows), the
top-contributor table of ``hlo_diag``, and the PyTorch counterpart
``trace_stats`` (FLOPs on local shards, per device, counted exactly).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core import hlo_diag as RD
from repro.core import roofline as RR
from repro.core.hw import V5E as REF_V5E
from repro.models.api import build_model as ref_build_model
from repro.models.api import input_specs as ref_input_specs
from repro.models.layers import ModelOptions as RefModelOptions
from repro.train import optimizer as ref_opt
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.core import hlo_diag as PD
from repro_torch.core import roofline as PR
from repro_torch.core.hw import H100, V5E
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import _mesh
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as sh

# --------------------------------------------------------------------------
# the HLO-text analyser: every case of tests/test_roofline.py, both parsers
# --------------------------------------------------------------------------


def _scan_hlo():
    def one(x, w):
        return x @ w

    def scanned(x, ws):
        def body(c, w):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, ws)
        return y

    x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    w1 = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    w10 = jax.ShapeDtypeStruct((10, 128, 128), jnp.float32)
    return (jax.jit(one).lower(x, w1).compile().as_text(),
            jax.jit(scanned).lower(x, w10).compile().as_text())


def _while_body_hlo():
    mesh = jax.make_mesh((1,), ("d",))
    from jax.sharding import PartitionSpec as JP

    def f(x, ws):
        def body(c, w):
            y = c @ w
            return jax.lax.with_sharding_constraint(y, JP()), None
        out, _ = jax.lax.scan(body, x, ws)
        return out.sum()

    x = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    ws = jax.ShapeDtypeStruct((7, 64, 64), jnp.float32)
    with jax.set_mesh(mesh):
        return jax.jit(f).lower(x, ws).compile().as_text()


RING_HLO = """
HloModule test

ENTRY %main (a: f32[1024,256]) -> f32[1024,256] {
  %a = f32[1024,256] parameter(0)
  %ar = f32[1024,256] all-reduce(%a), replica_groups=[4,8]<=[32]T(0), to_apply=%sum
  ROOT %ag = f32[1024,256] all-gather(%ar), replica_groups={{0,1,2,3}}, dimensions={0}
}
"""

ASYNC_HLO = """
HloModule t

ENTRY %main (a: f32[64]) -> f32[64] {
  %a = f32[64] parameter(0)
  %s = f32[64] all-gather-start(%a), replica_groups={{0,1}}, dimensions={0}
  ROOT %d = f32[64] all-gather-done(%s)
}
"""

DTYPE_HLO = """
HloModule t

ENTRY %main (a: bf16[100]) -> bf16[100] {
  %a = bf16[100] parameter(0)
  ROOT %ar = bf16[100] all-reduce(%a), replica_groups={{0,1}}, to_apply=%s
}
"""


def test_scan_trip_count_flops_in_both_parsers():
    one, ten = _scan_hlo()
    expected = 2 * 128 ** 3
    for hlo, n in ((one, 1), (ten, 10)):
        got = PR.hlo_stats(hlo)
        assert got == RR.hlo_stats(hlo)
        assert abs(got["flops"] - n * expected) / (n * expected) < 0.05


def test_while_body_collectives_multiplied_in_both_parsers():
    hlo = _while_body_hlo()
    got = PR.hlo_stats(hlo)
    assert got == RR.hlo_stats(hlo)
    expected = 7 * 2 * 64 ** 3
    assert abs(got["flops"] - expected) / expected < 0.05


@pytest.mark.parametrize("name, hlo", [("ring", RING_HLO),
                                       ("async", ASYNC_HLO),
                                       ("dtype", DTYPE_HLO)])
def test_collective_text_cases_in_both_parsers(name, hlo):
    got = PR.collective_bytes(hlo)
    assert got == RR.collective_bytes(hlo)
    assert PR.hlo_stats(hlo) == RR.hlo_stats(hlo)
    if name == "ring":
        r = 1024 * 256 * 4
        assert abs(got["all-reduce"] - 2 * r * 7 / 8) < 1
        assert abs(got["all-gather"] - r * 3 / 4) < 1
        assert got["count"] == 2
    elif name == "async":
        assert got["count"] == 1
    else:
        assert abs(got["all-reduce"] - 2 * 200 * 0.5) < 1


@pytest.mark.parametrize("op", PR._COLL_OPS)
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_ring_traffic_is_the_references_line_traffic(op, n):
    """Each collective kind over each group size: the port's factored
    ``ring_traffic`` equals what the reference's ``_line_traffic``
    charges for the same HLO line, and so does the port's own parser."""
    group = ",".join(str(i) for i in range(n))
    line = (f"%c = f32[1024,256] {op}(%a), replica_groups={{{{{group}}}}}, "
            f"dimensions={{0}}")
    want = RR._line_traffic(line)
    assert want is not None and want[0] == op
    assert PR._line_traffic(line) == want
    assert PR.ring_traffic(op, 1024 * 256 * 4, n) == want[1]


@pytest.fixture(scope="module")
def smoke_train_hlo():
    """The compiled HLO of the reference's smoke qwen2 train step on one
    device (``jax.checkpoint`` layers, AdamW), at B=2 x S=64."""
    from repro.configs.base import ShapeConfig
    cfg = ref_smoke_config(ref_get_config("qwen2_1_5b"))
    opts = RefModelOptions(dtype=jnp.bfloat16)
    pshapes = jax.eval_shape(lambda: ref_build_model(cfg, opts).init(
        jax.random.PRNGKey(0)))
    ostate = jax.eval_shape(ref_opt.init, pshapes)
    batch = ref_input_specs(cfg, ShapeConfig("t", 64, 2, "train"), opts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jax.jit(ref_make_train_step(cfg, opts)).lower(
            pshapes, ostate, batch).compile().as_text()


def test_hlo_stats_of_a_smoke_cell_are_the_references(smoke_train_hlo):
    got = PR.hlo_stats(smoke_train_hlo)
    assert got == RR.hlo_stats(smoke_train_hlo)
    assert got["flops"] > 0 and got["bytes"] > 0


def test_top_bytes_rows_are_the_references(smoke_train_hlo):
    got = PD.top_bytes(smoke_train_hlo)
    assert got == RD.top_bytes(smoke_train_hlo)
    assert len(got) == 20


def test_analyze_with_the_v5e_gives_the_references_report(smoke_train_hlo):
    args = ("qwen2_1_5b", "smoke", "1", 1, {}, smoke_train_hlo, 1e9)
    got = PR.analyze(*args, chip=V5E)
    want = RR.analyze(*args, chip=REF_V5E)
    assert got.row() == want.row()
    for field in ("hlo_flops", "hlo_bytes", "coll_bytes", "t_compute",
                  "t_memory", "t_collective", "model_flops"):
        assert getattr(got, field) == getattr(want, field), field
    assert PR.HEADER == RR.HEADER


def test_analyze_defaults_to_the_h100(smoke_train_hlo):
    args = ("qwen2_1_5b", "smoke", "1", 1, {}, smoke_train_hlo, 1e9)
    rep = PR.analyze(*args)
    assert rep.t_compute == rep.hlo_flops / H100.peak_flops_bf16
    assert rep.t_memory == rep.hlo_bytes / H100.hbm_bw


# --------------------------------------------------------------------------
# the PyTorch counterpart
# --------------------------------------------------------------------------

def test_trace_stats_counts_a_loop_of_matmuls_exactly():
    """The case where XLA's cost_analysis reports one matmul: ten fp32
    (128, 128) products, counted ten times, on fake tensors."""
    def loop(x, ws):
        for w in ws:
            x = x @ w
        return x

    x = torch.randn(128, 128)
    ws = [torch.randn(128, 128) for _ in range(10)]
    got = PR.trace_stats(loop, x, ws)
    assert got["flops"] == 10 * 2 * 128 ** 3
    assert set(got) == set(RR.hlo_stats(RING_HLO))
    assert got["count"] == 0 and got["total"] == 0
    # eager bytes: each product reads two (128, 128) fp32 inputs and
    # writes one
    assert got["bytes"] == 10 * 3 * 128 * 128 * 4


def test_trace_stats_counts_a_bf16_product_with_an_fp32_output():
    """``bmm(..., out_dtype=float32)``, the form the bf16 score products
    take on the card (``bmm.dtype``), counted as any bmm (traced on fake
    tensors: the CPU has no kernel for it)."""
    a = torch.randn(3, 16, 8).to(torch.bfloat16)
    b = torch.randn(3, 8, 32).to(torch.bfloat16)
    got = PR.trace_stats(lambda a, b: torch.bmm(a, b, out_dtype=torch.float32),
                         a, b)
    assert got["flops"] == 2 * 3 * 16 * 8 * 32
    assert got["flops"] == PR.bmm_flops((3, 16, 8), (3, 8, 32),
                                        torch.float32)


def test_trace_stats_matches_flop_counter_on_a_real_step():
    """A small two-layer MLP with its backward: the fake trace's FLOPs are
    FlopCounterMode's count of the same call on real tensors."""
    def step(x, w1, w2):
        y = torch.relu(x @ w1) @ w2
        return torch.autograd.grad(y.square().sum(), (w1, w2))

    x = torch.randn(32, 64)
    w1 = torch.randn(64, 128, requires_grad=True)
    w2 = torch.randn(128, 16, requires_grad=True)
    counter = FlopCounterMode(display=False)
    with counter:
        step(x, w1, w2)
    assert PR.trace_stats(step, x, w1, w2)["flops"] \
        == counter.get_total_flops()


def _local_flops(fn, *tensors):
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*tensors)
    return counter.get_total_flops()


@pytest.mark.parametrize("kv_heads", [4, 1], ids=["split_kv", "replicated_kv"])
def test_per_device_flops_are_the_local_shards_count(kv_heads):
    """On a fake (2, 2) (data, model) mesh: a batch-sharded activation
    times a column-sharded weight, then attention with the query heads
    over ``model`` — the KV heads split alike, or (one KV head) whole on
    every rank. The counted FLOPs are those of one rank's local shapes,
    not the global count FlopCounterMode gives for DTensor code."""
    b, s, d, h, hd = 4, 16, 32, 4, 8
    with fake_world(4):
        mesh = _mesh("cpu", (2, 2), ("data", "model"))
        counter = PR.TraceCounter(mesh)
        with counter:
            x = sh.distribute(torch.randn(b, s, d), sh.P("data", None, None),
                              mesh)
            w = sh.distribute(torch.randn(d, 64), sh.P(None, "model"), mesh)
            q = sh.distribute(torch.randn(b, s, h, hd),
                              sh.P("data", None, "model", None), mesh)
            kv_spec = (sh.P("data", None, "model", None) if kv_heads > 1
                       else sh.P("data", None, None, None))
            k, v = (sh.distribute(torch.randn(b, s, kv_heads, hd), kv_spec,
                                  mesh) for _ in range(2))
            pos = torch.arange(s).expand(b, s)
            opts = L.ModelOptions(dtype=torch.float32, attn_impl="naive")

            def step(x, w, q, k, v):
                with sh.use_mesh(mesh):
                    x @ w
                    L.attention(q, k, v, pos, pos, opts=opts)

            got = PR.trace_stats(step, x, w, q, k, v)
    lb, lh = b // 2, h // 2
    want = _local_flops(lambda a, m: a @ m, torch.randn(lb, s, d),
                        torch.randn(d, 32))
    lpos = torch.arange(s).expand(lb, s)
    want += _local_flops(
        lambda q, k, v: L.attention(q, k, v, lpos, lpos, opts=opts),
        torch.randn(lb, s, lh, hd),
        *(torch.randn(lb, s, max(1, kv_heads // 2), hd) for _ in range(2)))
    assert got["flops"] == want
    # the global count is four times as large
    glob = _local_flops(lambda a, m: a @ m, torch.randn(b, s, d),
                        torch.randn(d, 64))
    assert got["flops"] < glob


def test_traced_collectives_are_charged_by_ring_traffic():
    """An all-gather DTensor issues to gather a ``model``-sharded weight
    is counted once, by ``ring_traffic`` over its group's two ranks, and
    attributed to the ``model`` axis."""
    with fake_world(4):
        mesh = _mesh("cpu", (2, 2), ("data", "model"))
        counter = PR.TraceCounter(mesh)
        with counter:
            w = sh.distribute(torch.randn(64, 32), sh.P(None, "model"), mesh)
            got = PR.trace_stats(lambda w: sh.gather_dim(w, 1), w)
        by_axis = counter.traffic_by_axis()
    want = PR.ring_traffic("all-gather", 64 * 32 * 4 / 2 * 2, 2)
    assert got["count"] == 1
    assert got["all-gather"] == want == got["total"]
    assert by_axis == {"model": want}


def test_top_ops_lists_the_largest_traced_ops():
    def step(x, w):
        return (x @ w).relu()

    counter = PR.TraceCounter()
    with counter:
        x, w = torch.randn(64, 32), torch.randn(32, 128)
    PR.trace_stats(step, x, w)
    rows = PD.top_ops(counter.records)
    # relu reads and writes (64, 128); the product reads two inputs and
    # writes (64, 128)
    assert [(r[3], r[0]) for r in rows] == [
        ("aten.relu.default", 2 * 64 * 128 * 4),
        ("aten.mm.default", (64 * 32 + 32 * 128 + 64 * 128) * 4)]
    assert all(r[0] == r[1] * r[2] for r in rows)


def test_analyze_trace_charges_the_pod_axis_at_the_dcn_rate():
    stats = {op: 0.0 for op in PR._COLL_OPS}
    stats.update(flops=1e12, bytes=1e10, count=2, total=3e9,
                 **{"all-reduce": 3e9})
    rep = PR.analyze_trace("a", "s", "2x16x16", 512, stats, 1e15,
                           dcn_traffic=1e9)
    ici = H100.ici_link_bw * H100.ici_links_per_axis
    assert rep.t_collective == max(2e9 / ici, 1e9 / H100.dcn_bw)
    assert rep.t_compute == 1e12 / H100.peak_flops_bf16
    assert rep.t_memory == 1e10 / H100.hbm_bw
    assert rep.step_time_bound == max(rep.t_compute, rep.t_memory,
                                      rep.t_collective)
    assert rep.row().startswith("a,s,2x16x16,512,")
    np.testing.assert_allclose(rep.useful_flops_ratio, 1e15 / (512 * 1e12))


def test_a_depthwise_convolutions_backward_is_counted_by_its_groups():
    """The SSM's depthwise conv (``groups`` = channels): its weight
    gradient is counted over each channel's own input, as its forward
    and its input gradient are, both in a trace and by FlopCounterMode
    with :data:`CUSTOM_FLOPS` (torch's own formula counts it as if every
    input channel met every output channel)."""
    b, c, s, k = 2, 8, 32, 4
    x = torch.randn(b, c, s + k - 1, requires_grad=True)
    w = torch.randn(c, 1, k, requires_grad=True)

    def step(x, w):
        y = torch.nn.functional.conv1d(x, w, groups=c)
        return torch.autograd.grad(y.square().sum(), (x, w))

    forward = 2 * b * c * s * k
    assert PR.trace_stats(step, x, w)["flops"] == 3 * forward
    counter = FlopCounterMode(display=False, custom_mapping=PR.CUSTOM_FLOPS)
    with counter:
        step(x, w)
    assert counter.get_total_flops() == 3 * forward


#: (q positions, k positions, causal, window) as each is made in a step
POSITION_CASES = {
    "second_half_against_the_whole": (
        lambda: torch.arange(128).expand(2, 128)[:, 64:],
        lambda: torch.arange(128).expand(2, 128), True, None),
    "window": (lambda: torch.arange(64).expand(2, 64),
               lambda: torch.arange(64).expand(2, 64), True, 8),
    "keys_after_the_queries": (
        lambda: torch.arange(64).expand(2, 64),
        lambda: (torch.arange(64) + 64).expand(2, 64), True, None),
    "offset_bidirectional": (
        lambda: torch.arange(64).expand(2, 64) + 1000,
        lambda: torch.arange(96).expand(2, 96) + 990, False, 16),
}


@pytest.mark.parametrize("case", sorted(POSITION_CASES))
def test_a_trace_decides_block_pairs_from_the_positions_values(case):
    """The positions a traced step makes carry their values through the
    trace, so the blockwise attention's block pairs are those of the
    real positions, whatever their layout."""
    make_q, make_k, causal, window = POSITION_CASES[case]
    got = []

    def step(x):
        got.append(L._block_pairs(make_q(), make_k(), causal, window, 8,
                                  8))

    PR.trace_stats(step, torch.zeros(1))
    want = L._block_pairs(make_q(), make_k(), causal, window, 8, 8)
    assert got == [want]
    assert {kind for row in want for kind in row} != {L.PARTIAL}


def test_a_trace_refuses_positions_it_does_not_know():
    """On two fake ranks the ring's second step attends to positions
    received from the other rank, which rank 0's trace cannot know: the
    trace raises rather than guess the block pairs."""
    q = torch.randn(2, 32, 4, 16)
    k = v = torch.randn(2, 32, 2, 16)
    pos = torch.arange(32).expand(2, 32)
    with fake_world(2):
        mesh = _mesh("cpu", (2,), ("cp",))

        def step(q, k, v, pos):
            with sh.use_mesh(mesh):
                return L.ring_attention(q, k, v, pos, pos, "cp", True, None,
                                        8, 8)

        with pytest.raises(RuntimeError, match="does not know"):
            PR.trace_stats(step, q, k, v, pos)
