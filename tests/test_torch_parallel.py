"""The port's parallel layer against the reference's: ring attention
(``attention_partial``, ``combine_attention_partials``,
``ring_attention``), the expert-parallel MoE (``moe_ep_a2a``), the
sharding constraints, attention on DTensors, the train step with
``grad_specs`` and the training launcher.

One rank runs in this process (a gloo group through a ``FileStore``);
2 and 4 ranks run in spawned processes of ``tests/test_torch_ranks.py``,
once per world size for the whole module, held against the reference's
own run on as many forced CPU devices in a child process. Bars: fp32
attention 2e-5 and bf16 2e-2 (the reference's kernel tests); the MoE's
y 1e-5 and aux rtol 1e-5 (``tests/test_moe.py``); gradients 2e-5 ×
max|g| per leaf.
"""
import dataclasses
import subprocess
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh

import test_torch_ranks as ranks
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import layers as RL
from repro.models import moe as RM
from repro_torch.configs.base import MoEConfig, get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.api import build_model
from repro_torch.parallel import sharding as sh
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import leaf_paths, leaves

BAR = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process, with a (1, 1) (data,
    model) mesh and a (1,) cp mesh."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield {"dm": init_device_mesh("cpu", (1, 1),
                                      mesh_dim_names=("data", "model")),
               "cp": init_device_mesh("cpu", (1,), mesh_dim_names=("cp",))}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: (reference outputs, [rank outputs])} for 2 and 4 ranks, run
    concurrently."""
    base = tmp_path_factory.mktemp("ranks")
    jobs = {2: ["ring", "ring_grad", "ep", "attention", "attention_rkv"],
            4: ["ring", "ring_grad", "ep", "fsdp_step", "decode",
                "tp_step", "uneven", "serve_decode", "baseline"]}
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(ranks.run, jobs[n], n, base / f"w{n}")
                   for n in jobs}
        return {n: f.result() for n, f in futures.items()}


def _jdt(dtype):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]


def _tdt(dtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


# --------------------------------------------------------------------------
# ring attention
# --------------------------------------------------------------------------

def _reference_partials(q, k, v, qpos, block):
    parts = []
    for lo, hi in ((0, 32), (32, 64), (64, 96)):
        o, lse = RL.attention_partial(q, k[:, lo:hi], v[:, lo:hi], qpos,
                                      qpos[:, lo:hi], causal=True,
                                      block_q=block, block_kv=block)
        parts.append((np.asarray(o), np.asarray(lse)))
    return parts


def test_attention_partial_has_the_references_layout_and_values():
    """out (B,S,H,hd) and lse (B,S,H) as the reference's, on every row
    that has a key in the partial; on the rows with none both lse are
    -1e30 (so they weigh nothing when combined)."""
    q, k, v, pos = ranks.ring_inputs("fp32_causal_gqa")
    q, k, v = q[:, :48], k[:, :48], v[:, :48]
    pos = pos[:, :48]
    lo = 16                                  # rows < 16 see no key
    want_o, want_lse = RL.attention_partial(
        jnp.asarray(q), jnp.asarray(k[:, lo:]), jnp.asarray(v[:, lo:]),
        jnp.asarray(pos), jnp.asarray(pos[:, lo:]), True, None, 8, 8)
    got_o, got_lse = L.attention_partial(
        torch.from_numpy(q), torch.from_numpy(k[:, lo:]),
        torch.from_numpy(v[:, lo:]), torch.from_numpy(pos),
        torch.from_numpy(pos[:, lo:]), True, None, 8, 8)
    assert got_o.shape == want_o.shape and got_lse.shape == want_lse.shape
    assert got_o.dtype == torch.float32 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy()[:, lo:],
                               np.asarray(want_o)[:, lo:], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got_lse.numpy()[:, lo:],
                               np.asarray(want_lse)[:, lo:], atol=2e-5,
                               rtol=2e-5)
    assert (got_lse.numpy()[:, :lo] <= -1e29).all()
    assert (np.asarray(want_lse)[:, :lo] <= -1e29).all()


def test_combine_attention_partials_matches_full():
    """The reference's identity test over the port: partials against
    disjoint KV shards (one of them fully masked for the first rows)
    combine to the full attention, and to the reference's combination."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 96, 4, 32), dtype=np.float32)
               for _ in range(3))
    qpos = np.broadcast_to(np.arange(96, dtype=np.int32), (2, 96)).copy()
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, qpos))
    full = L.attention_naive(tq, tk, tv, tp, tp, causal=True)
    parts = [L.attention_partial(tq, tk[:, lo:hi], tv[:, lo:hi], tp,
                                 tp[:, lo:hi], causal=True, block_q=32,
                                 block_kv=32)
             for lo, hi in ((0, 32), (32, 64), (64, 96))]
    got = L.combine_attention_partials([p[0] for p in parts],
                                       [p[1] for p in parts])
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5,
                               rtol=2e-5)
    refp = _reference_partials(*(jnp.asarray(a) for a in (q, k, v, qpos)),
                               32)
    want = RL.combine_attention_partials([jnp.asarray(p[0]) for p in refp],
                                         [jnp.asarray(p[1]) for p in refp])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _reference_ring_one_device(q, k, v, pos, causal, window, block):
    mesh = jax.make_mesh((1,), ("cp",))
    f = jax.shard_map(
        lambda q, k, v, p: RL.ring_attention(q, k, v, p, p, "cp", causal,
                                             window, block, block),
        mesh=mesh, in_specs=(JP(None, "cp"),) * 4, out_specs=JP(None, "cp"))
    with warnings.catch_warnings():
        # jax.lax.pvary warns under jax 0.9; pyproject.toml makes that an
        # error for repro's frames
        warnings.simplefilter("ignore", DeprecationWarning)
        with jax.set_mesh(mesh):
            return np.asarray(jax.jit(f)(q, k, v, pos).astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(ranks.RING_CASES))
def test_ring_attention_on_one_rank_matches_the_reference(one_rank, case):
    dtype, causal, window, _ = ranks.RING_CASES[case]
    q, k, v, pos = ranks.ring_inputs(case)
    blk = ranks.RING_SHAPE["block"]
    want = _reference_ring_one_device(
        *(jnp.asarray(a).astype(_jdt(dtype)) for a in (q, k, v)),
        jnp.asarray(pos), causal, window, blk)
    tq, tk, tv = (torch.from_numpy(a).to(_tdt(dtype)) for a in (q, k, v))
    tp = torch.from_numpy(pos)
    with sh.use_mesh(one_rank["cp"]):
        got = L.ring_attention(tq, tk, tv, tp, tp, "cp", causal, window,
                               blk, blk)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BAR[dtype],
                               rtol=BAR[dtype])
    # one partial at weight exp(0) = 1: the flash attention's own bits
    plain = L.attention_flash_torch(tq, tk, tv, tp, tp, causal, window,
                                    blk, blk)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(ranks.RING_CASES))
def test_ring_attention_matches_the_reference_on_n_devices(worlds, n, case):
    """Sequence sharded over n ranks (windowed cases: whole shards fall
    outside the window; causal: every later shard is fully masked)."""
    ref, outs = worlds[n]
    key = f"ring/{case}"
    got = np.concatenate([o[key] for o in outs], axis=1)
    bar = BAR[ranks.RING_CASES[case][0]]
    np.testing.assert_allclose(got, ref[key], atol=bar, rtol=bar)


def _assert_grads_close(got, want, dtype, what):
    bar = BAR[dtype]
    for g in "qkv":
        np.testing.assert_allclose(got[g], want[g], atol=bar, rtol=bar,
                                   err_msg=f"{what}: d{g}")


@pytest.mark.parametrize("case", sorted(ranks.RING_CASES))
def test_ring_attention_gradients_on_one_rank_match_jax_grad(one_rank,
                                                             case):
    """The ring's backward on one rank (nothing sent) against ``jax.grad``
    of the reference's ring on one device."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ranks.reference_ring_grad_case(1, case)
    got = ranks.ring_grad_local(one_rank["cp"], "cp", slice(None), case)
    _assert_grads_close(got, want, ranks.RING_CASES[case][0], case)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(ranks.RING_CASES))
def test_ring_attention_gradients_match_jax_grad_on_n_devices(worlds, n,
                                                              case):
    """dQ stays on its rank; dK and dV come back round the ring to the
    rank that owns their shard: each rank's gradients, concatenated over
    the sequence, equal the reference's ``jax.grad`` on n devices."""
    ref, outs = worlds[n]
    got = {g: np.concatenate([o[f"ring_grad/{case}/{g}"] for o in outs],
                             axis=1) for g in "qkv"}
    want = {g: ref[f"ring_grad/{case}/{g}"] for g in "qkv"}
    _assert_grads_close(got, want, ranks.RING_CASES[case][0], case)


def test_ring_attention_forward_is_unchanged_under_autograd(one_rank):
    """With gradients on, the ring's output is the same bits as without."""
    q, k, v, pos = ranks.ring_inputs("bf16_causal_gqa")
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tp = torch.from_numpy(pos)
    with sh.use_mesh(one_rank["cp"]):
        with torch.no_grad():
            plain = L.ring_attention(tq, tk, tv, tp, tp, "cp", True, None,
                                     8, 8)
        graded = L.ring_attention(tq.requires_grad_(), tk, tv, tp, tp, "cp",
                                  True, None, 8, 8)
    assert graded.grad_fn is not None
    assert torch.equal(graded.detach(), plain)


def test_ring_attention_needs_a_mesh():
    q, k, v, pos = ranks.ring_inputs("fp32_causal_gqa")
    tp = torch.from_numpy(pos)
    with pytest.raises(RuntimeError, match="no mesh"):
        L.ring_attention(*map(torch.from_numpy, (q, k, v)), tp, tp, "cp")


# --------------------------------------------------------------------------
# expert parallelism
# --------------------------------------------------------------------------

def _moe_setup():
    x, arrays = ranks.moe_inputs()
    kw = ranks.moe_kwargs()
    return x, arrays, MoEConfig(**kw), RefMoEConfig(**kw)


EP_OPTS = dict(moe_impl="ep_a2a", ep_axis="model", dp_axes=("data",))


def test_ep_a2a_matches_gather_single_shard(one_rank):
    """The reference's own case over the port: on a (1, 1) mesh the
    all-to-all path reproduces the gather path (and the reference's
    gather), with plain tensors and with DTensors."""
    x, arrays, mcfg, rcfg = _moe_setup()
    px = torch.from_numpy(x)
    pp = {k: torch.from_numpy(v) for k, v in arrays.items()}
    ry, raux = RM.moe_ffn(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in arrays.items()},
                          rcfg, "gather")
    mesh = one_rank["dm"]
    before = M.A2A_CALLS
    with sh.use_mesh(mesh):
        y, aux = M.moe_ffn(px, pp, mcfg, "ep_a2a",
                           L.ModelOptions(**EP_OPTS))
        dy, daux = M.moe_ffn(sh.distribute(px, sh.P(("data",), "model",
                                                     None), mesh),
                             pp, mcfg, "ep_a2a", L.ModelOptions(**EP_OPTS))
    assert M.A2A_CALLS - before == 4          # two a call
    gy, gaux = M.moe_ffn(px, pp, mcfg, "gather")
    for got, got_aux in ((y, aux), (dy.full_tensor(), daux.full_tensor())):
        np.testing.assert_allclose(got.numpy(), gy.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ry), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got_aux), float(raux), rtol=1e-5)
        np.testing.assert_allclose(float(got_aux), float(gaux), rtol=1e-5)


def test_ep_a2a_gradients_match_jax_grad_single_shard(one_rank):
    x, arrays, mcfg, _ = _moe_setup()
    want = ranks.reference_moe((1, 1), x, arrays, grad=True)
    got = ranks._moe_port(one_rank["dm"], x, arrays, grad=True)
    for name in [k for k in want if k.startswith("grad/")]:
        w = want[name]
        assert np.abs(got[name] - w).max() <= 2e-5 * np.abs(w).max(), name
    np.testing.assert_allclose(got["y"], want["y"], atol=1e-5, rtol=1e-5)


def _dropped(x, arrays, mcfg, mesh_shape):
    """Tokens' chosen experts that miss their queue's capacity, summed
    over the ranks' local token sets of ``mesh_shape``."""
    dp, ep = mesh_shape
    b, s = x.shape[:2]
    total = 0
    for i in range(dp):
        for j in range(ep):
            xl = x[i * b // dp:(i + 1) * b // dp, j * s // ep:(j + 1) * s // ep]
            x2d = torch.from_numpy(xl.reshape(-1, xl.shape[-1]))
            cap = M.capacity(x2d.shape[0], mcfg)
            _, topi, sel, _ = M._routing(
                x2d, torch.from_numpy(arrays["router"]), mcfg, cap)
            # a chosen expert whose queue holds more than cap tokens
            # drops the ones past cap
            load = torch.isfinite(sel).sum(0)
            total += int(torch.clamp(load - cap, min=0).sum())
    return total


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_a2a_matches_the_reference_on_the_same_mesh(worlds, mesh_shape):
    """At the config's capacity, where tokens are dropped (capacity is per
    rank: the result differs from the gather path, as in the
    reference)."""
    x, arrays, mcfg, _ = _moe_setup()
    assert _dropped(x, arrays, mcfg, mesh_shape) > 0
    ref, outs = worlds[mesh_shape[0] * mesh_shape[1]]
    key = f"ep/{mesh_shape[0]}x{mesh_shape[1]}"
    for out in outs:                     # every rank holds the whole y
        np.testing.assert_allclose(out[f"{key}/y"], ref[f"{key}/y"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out[f"{key}/aux"], ref[f"{key}/aux"],
                                   rtol=1e-5)


def test_ep_a2a_gradients_match_jax_grad_on_two_ranks(worlds):
    """Each rank back-propagates its own tokens' loss plus aux/2; the
    experts' gradients reach their owners through the all-to-all's
    transpose, the replicated router's add up over the ranks."""
    ref, outs = worlds[2]
    key = "ep/1x2/grad"
    for name in ("w_gate", "w_up", "w_down", "x", "router"):
        w = ref[f"{key}/{name}"]
        if name == "router":
            got = [sum(o[f"{key}/router"] for o in outs)]
        else:
            got = [o[f"{key}/{name}"] for o in outs]
        for g in got:
            assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), name


def test_the_ep_model_equals_the_gather_model(one_rank):
    """A smoke MoE model's forward under ``moe_impl="ep_a2a"`` on a
    (1, 1) mesh equals its ``gather`` forward, two all-to-alls a layer."""
    cfg = smoke_config(get_config("qwen3_moe_30b_a3b"))
    opts = L.ModelOptions(dtype=torch.float32)
    params = build_model(cfg, opts).init(torch.Generator().manual_seed(0),
                                         "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    want = build_model(cfg, opts).forward(params, {"tokens": tokens})
    before = M.A2A_CALLS
    with sh.use_mesh(one_rank["dm"]):
        got = build_model(cfg, dataclasses.replace(opts, **EP_OPTS)).forward(
            params, {"tokens": tokens})
    assert M.A2A_CALLS - before == 2 * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_ep_a2a_refuses_a_plain_tensor_on_many_ranks():
    class TwoRanks:
        mesh_dim_names = ("data", "model")

        def size(self, dim=None):
            return 2 if dim is None else (1, 2)[dim]

        def get_group(self, axis):
            return None

    x, arrays, mcfg, _ = _moe_setup()
    with sh.use_mesh(TwoRanks()), pytest.raises(ValueError,
                                                match="takes DTensors"):
        M.moe_ep_a2a(torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in arrays.items()},
                     mcfg, L.ModelOptions(**EP_OPTS))


# --------------------------------------------------------------------------
# constraints and attention on DTensors
# --------------------------------------------------------------------------

def test_constrain_places_on_the_current_mesh(one_rank):
    from torch.distributed.tensor import Replicate, Shard
    mesh = one_rank["dm"]
    x = torch.randn(2, 8, 4, 16, generator=torch.Generator().manual_seed(0))
    opts = L.ModelOptions(act_spec=sh.P("data", None, None, None),
                          qkv_spec=sh.P("data", None, "model", None),
                          kv_spec=sh.P(None, None, None, None))
    with sh.use_mesh(mesh):
        a = L.constrain(x, opts)
        q = L.constrain_qkv(x, opts)
        kv = L.constrain_qkv(x, opts, is_kv=True)
        again = L.constrain(a, opts)
    assert a.placements == (Shard(0), Replicate())
    assert q.placements == (Shard(0), Shard(2))
    assert kv.placements == (Replicate(), Replicate())
    assert again.placements == a.placements
    for t in (a, q, kv, again):
        assert torch.equal(t.full_tensor(), x)
    plain = L.ModelOptions()
    assert L.constrain(x, plain) is x
    assert L.constrain_qkv(x, plain, is_kv=True) is x


def test_a_spec_without_a_mesh_raises():
    x = torch.zeros(2, 4)
    with pytest.raises(RuntimeError, match="no mesh"):
        L.constrain(x, L.ModelOptions(act_spec=sh.P("data", None)))
    with pytest.raises(RuntimeError, match="no mesh"):
        L.constrain_qkv(x, L.ModelOptions(kv_spec=sh.P(None, None)),
                        is_kv=True)


@pytest.mark.parametrize("impl", ["naive", "flash_torch"])
@pytest.mark.parametrize("spec", [("data", None, "model", None),
                                  (None, None, None, None)],
                         ids=["batch_heads", "replicated"])
def test_attention_on_dtensors_equals_the_plain_call(one_rank, impl, spec):
    q, k, v, pos = ranks.ring_inputs("fp32_window_gqa")
    q, k, v = map(torch.from_numpy, (q, k, v))
    pos = torch.from_numpy(pos)
    opts = L.ModelOptions(dtype=torch.float32, attn_impl=impl, block_q=16,
                          block_kv=16)
    want = L.attention(q, k, v, pos, pos, window=8, opts=opts)
    mesh = one_rank["dm"]
    got = L.attention(*(sh.distribute(t, sh.P(*spec), mesh)
                        for t in (q, k, v)), pos, pos, window=8, opts=opts)
    assert sh.is_dtensor(got)
    assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("impl", ["naive", "flash_torch"])
def test_attention_with_heads_sharded_over_two_ranks(worlds, impl):
    """Heads split over a 2-rank ``model`` axis: each rank computes its 2
    query heads over its KV head; the result equals the plain call."""
    _, outs = worlds[2]
    for o in outs:
        assert list(o[f"attention/{impl}/placements"]) == [False, True]
        assert int(o[f"attention/{impl}/local_heads"]) == 2
        np.testing.assert_allclose(o[f"attention/{impl}/got"],
                                   o[f"attention/{impl}/want"], atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("impl", ["naive", "flash_torch"])
def test_attention_with_the_sequence_sharded_over_two_ranks(worlds, impl):
    """Context parallelism by an all-gather (the ``fsdp_cp`` mapping's
    layout): each rank's queries attend to the whole K/V at their
    absolute positions; output and q, k, v gradients equal the plain
    call's on every rank."""
    _, outs = worlds[2]
    key = f"attention/{impl}/seq"
    for o in outs:
        np.testing.assert_allclose(o[f"{key}/got"],
                                   o[f"attention/{impl}/want"],
                                   atol=BAR["float32"], rtol=BAR["float32"])
        for g in "qkv":
            np.testing.assert_allclose(o[f"{key}/grad_{g}"],
                                       o[f"{key}/want_{g}"],
                                       atol=BAR["float32"],
                                       rtol=BAR["float32"], err_msg=g)


@pytest.mark.parametrize("impl", ["naive", "flash_torch"])
def test_sequence_sharded_attention_matches_the_reference(worlds, impl):
    """The same context-parallel call against the reference's attention
    with the sequence placed over ``model`` on two devices (XLA
    partitions it): output and q, k, v gradients on every rank."""
    ref, outs = worlds[2]
    key = f"attention/{impl}/seq"
    for o in outs:
        np.testing.assert_allclose(o[f"{key}/got"], ref[f"{key}/ref"],
                                   atol=BAR["float32"], rtol=BAR["float32"])
        for g in "qkv":
            np.testing.assert_allclose(o[f"{key}/grad_{g}"],
                                       ref[f"{key}/ref_{g}"],
                                       atol=BAR["float32"],
                                       rtol=BAR["float32"], err_msg=g)


@pytest.mark.parametrize("impl", ["naive", "flash_torch"])
def test_attention_with_one_kv_head_for_two_ranks(worlds, impl):
    """Four query heads over two ranks read one KV head, which no rank
    split can share out: K and V stay whole on each rank, each rank
    attends with the KV head of its query heads, and the K/V gradients
    are summed over the ranks. Output and gradients equal the plain
    call's on every rank."""
    _, outs = worlds[2]
    key = f"attention_rkv/{impl}"
    for o in outs:
        np.testing.assert_allclose(o[f"{key}/got"], o[f"{key}/want"],
                                   atol=BAR["float32"], rtol=BAR["float32"])
        for g in "qkv":
            np.testing.assert_allclose(o[f"{key}/grad_{g}"],
                                       o[f"{key}/want_{g}"],
                                       atol=BAR["float32"],
                                       rtol=BAR["float32"], err_msg=g)


@pytest.mark.parametrize("impl", ["naive", "flash_torch"])
def test_fsdp_step_on_a_2x2_mesh_equals_the_plain_step(worlds, impl):
    """The smoke qwen2 step over four gloo ranks, ``embed`` placed
    ``P("model", "data")`` (vocabulary over ``model``, d over ``data``):
    the lookup gathers the table's FSDP shard first, so it runs, and the
    loss is the plain step's to one fp32 ulp, the gradient norm equal."""
    _, outs = worlds[4]
    for o in outs:
        key = f"fsdp_step/{impl}"
        assert set(o[f"{key}/embed_placements"]) == {"S(0)", "S(1)"}
        want = o[f"{key}/want_loss"]
        assert abs(o[f"{key}/loss"] - want) <= np.spacing(want)
        assert o[f"{key}/grad_norm"] == o[f"{key}/want_grad_norm"]


@pytest.mark.parametrize("name", sorted(ranks.DECODE_MESHES))
def test_decode_on_a_placed_cache_equals_the_plain_decode(worlds, name):
    """Greedy decode with the parameters and the KV cache placed over
    four ranks (the cache's sequence split where ``cache_specs`` splits
    it, attended in parts and combined) gives the plain decode's logits
    at every step (fp32, 1e-5: the parts change the sums' order; bf16
    at its bar: each part's output is rounded to bf16 before the sum)."""
    _, outs = worlds[4]
    bar = {"float32": 1e-5, "bfloat16": BAR["bfloat16"]}[
        ranks.DECODE_MESHES[name][2]]
    for o in outs:
        key = f"decode/{name}"
        assert bool(o[f"{key}/seq_sharded"]) == name.startswith("seq")
        np.testing.assert_allclose(o[f"{key}/got"], o[f"{key}/want"],
                                   atol=bar, rtol=bar)


@pytest.mark.parametrize("arch", ranks.FSDP_FAMILIES
                         + tuple(ranks.FSDP_CP_STEPS))
def test_fsdp_step_of_each_family_on_a_2x2_mesh(worlds, arch):
    """The SSM family (its block split over ``model`` by heads, weights
    entering whole), the hybrid (the same SSM split beside attention and
    the gather MoE), the audio enc-dec, the VLM, and under the
    ``fsdp_cp`` mapping (the sequence over ``model``, weights whole, K/V
    gathered) qwen2, the MoE (every expert's queue formed whole, the
    capacity slots split over the four ranks) and the VLM (patch
    embeddings and tokens): loss and gradient norm within two fp32 ulps
    of the plain step's (a shard's products sum in another order than
    the whole batch's). Under ``fsdp_cp`` the residual stream enters
    the first layer split along the sequence over ``model``."""
    _, outs = worlds[4]
    for o in outs:
        for k in ("loss", "grad_norm"):
            want = o[f"fsdp_step/{arch}/want_{k}"]
            assert abs(o[f"fsdp_step/{arch}/{k}"] - want) \
                <= 2 * np.spacing(want), k
        if arch in ranks.FSDP_CP_STEPS:
            assert list(o[f"fsdp_step/{arch}/stream_placements"]) == [
                "S(0)", "S(1)"]


@pytest.mark.parametrize("name", [n for n in ranks.FSDP_CP_STEPS
                                  if n != "fsdp_cp"])
def test_fsdp_cp_step_matches_the_reference(worlds, name):
    """The MoE's and the VLM's smoke steps under ``fsdp_cp`` on the
    2 x 2 mesh against the reference's own loss (plain, fp32, naive
    attention) on the same parameters and batch: rtol 1e-5."""
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import smoke_config as ref_smoke_config
    from repro.models import api as ref_api
    model = ref_api.build_model(
        ref_smoke_config(ref_get_config(ranks.FSDP_CP_STEPS[name])),
        RL.ModelOptions(dtype=jnp.float32, remat=False, attn_impl="naive"))
    key = f"fsdp_step/{name}"
    _, outs = worlds[4]
    tree, batch = _reference_inputs(outs[0], key)
    want = float(model.loss(tree, batch))
    for o in outs:
        np.testing.assert_allclose(o[f"{key}/loss"], want, rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(ranks.TP_STEPS))
def test_train_step_with_one_head_a_rank_equals_the_plain_step(worlds,
                                                                arch):
    """t5's train step widened to one attention head a ``model`` rank,
    under the dry run's Megatron-SP options: the attention hands its
    gradients back to DTensor contiguous, so the backward's folds of
    (B, S, d) run, and the loss and gradient norm are the plain step's
    within two fp32 ulps."""
    _, outs = worlds[4]
    for o in outs:
        for k in ("loss", "grad_norm"):
            want = o[f"tp_step/{arch}/want_{k}"]
            assert abs(o[f"tp_step/{arch}/{k}"] - want) \
                <= 2 * np.spacing(want), k


@pytest.mark.parametrize("arch", sorted(ranks.UNEVEN))
def test_uneven_heads_and_vocabulary_train_step_equals_the_plain_step(
        worlds, arch):
    """A smoke config with 3 heads and a vocabulary of 257 on its mesh
    under the dry run's options (``ranks.UNEVEN``): each rank projects
    its rows, the heads padded to a multiple of ``model`` (qwen2 on
    (2, 2): the second rank's last slot empty; whisper on (1, 4): the
    last rank's only slot), the cross-entropy on each rank's rows by the
    whole head. The loss and the gradient norm are the plain step's
    (``train_check``'s bars: rtol 1e-5, 1e-4)."""
    _, outs = worlds[4]
    for o in outs:
        key = f"uneven/{arch}/train"
        np.testing.assert_allclose(o[f"{key}/loss"], o[f"{key}/want_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o[f"{key}/grad_norm"],
                                   o[f"{key}/want_grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("arch", sorted(ranks.UNEVEN))
def test_uneven_heads_and_vocabulary_prefill_equals_the_plain_forward(
        worlds, arch):
    """The same configs' prefill logits on their meshes equal the plain
    forward's (fp32, 1e-5)."""
    _, outs = worlds[4]
    for o in outs:
        key = f"uneven/{arch}/prefill"
        np.testing.assert_allclose(o[f"{key}/logits"],
                                   o[f"{key}/want_logits"], atol=1e-5,
                                   rtol=1e-5)


def _reference_inputs(o, key):
    """The reference's parameter tree and batch from the ``uneven``
    job's rank-0 outputs under ``key``."""
    tree, batch = {}, {}
    for name, v in o.items():
        if name.startswith(f"{key}/param/"):
            *path, leaf = name[len(f"{key}/param/"):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v)
        elif name.startswith(f"{key}/batch/"):
            batch[name[len(f"{key}/batch/"):]] = jnp.asarray(v)
    return tree, batch


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", sorted(ranks.UNEVEN))
def test_uneven_heads_and_vocabulary_on_a_mesh_match_the_reference(
        worlds, arch, kind):
    """The same configs on their meshes against the reference's own
    loss and prefill logits (plain, fp32, naive attention) on the same
    parameters and batch: the loss at rtol 1e-5, the logits at 1e-5."""
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import smoke_config as ref_smoke_config
    from repro.models import api as ref_api
    widths, _ = ranks.UNEVEN[arch]
    ref_cfg = dataclasses.replace(ref_smoke_config(ref_get_config(arch)),
                                  **widths)
    model = ref_api.build_model(ref_cfg, RL.ModelOptions(
        dtype=jnp.float32, remat=False, attn_impl="naive"))
    key = f"uneven/{arch}/{kind}"
    _, outs = worlds[4]
    tree, batch = _reference_inputs(outs[0], key)
    if kind == "train":
        want = float(model.loss(tree, batch))
        for o in outs:
            np.testing.assert_allclose(o[f"{key}/loss"], want, rtol=1e-5)
        return
    want = np.asarray(model.forward(tree, batch))
    for o in outs:
        np.testing.assert_allclose(o[f"{key}/logits"], want, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", sorted(ranks.BASELINE))
def test_baseline_train_step_equals_the_plain_step(worlds, name):
    """A smoke config on its mesh under the dry run's ``--baseline``
    options and placements (``ranks.BASELINE``: no residual-stream or
    head spec, weights split over ``model`` alone): Megatron's column-
    then row-parallel products with each block's output and its input's
    gradient all-reduced, attention on each rank's heads — whole heads,
    2 heads gathered by groups of 2 of 4 ranks, 3 heads by the whole of
    ``model`` — and the MoE's tokens gathered into each rank's experts'
    slots by hand. The loss and the gradient norm are the plain step's
    (``train_check``'s bars: rtol 1e-5, 1e-4)."""
    _, outs = worlds[4]
    for o in outs:
        key = f"baseline/{name}/train"
        np.testing.assert_allclose(o[f"{key}/loss"], o[f"{key}/want_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o[f"{key}/grad_norm"],
                                   o[f"{key}/want_grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("name", sorted(ranks.BASELINE))
def test_baseline_prefill_equals_the_plain_forward(worlds, name):
    """The same configs' prefill logits on their meshes under
    ``--baseline`` equal the plain forward's (fp32, 1e-5)."""
    _, outs = worlds[4]
    for o in outs:
        key = f"baseline/{name}/prefill"
        np.testing.assert_allclose(o[f"{key}/logits"],
                                   o[f"{key}/want_logits"], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("name", sorted(ranks.BASELINE))
def test_baseline_on_a_mesh_matches_the_reference(worlds, name, kind):
    """The same runs against the reference's own loss and prefill logits
    (plain, fp32, naive attention, the MoE under ``gather``) on the same
    parameters and batch: the loss at rtol 1e-5, the logits at 1e-5."""
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import smoke_config as ref_smoke_config
    from repro.models import api as ref_api
    arch, widths, _ = ranks.BASELINE[name]
    ref_cfg = dataclasses.replace(ref_smoke_config(ref_get_config(arch)),
                                  **widths)
    model = ref_api.build_model(ref_cfg, RL.ModelOptions(
        dtype=jnp.float32, remat=False, attn_impl="naive"))
    key = f"baseline/{name}/{kind}"
    _, outs = worlds[4]
    tree, batch = _reference_inputs(outs[0], key)
    if kind == "train":
        want = float(model.loss(tree, batch))
        for o in outs:
            np.testing.assert_allclose(o[f"{key}/loss"], want, rtol=1e-5)
        return
    want = np.asarray(model.forward(tree, batch))
    for o in outs:
        np.testing.assert_allclose(o[f"{key}/logits"], want, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(ranks.SERVE_DECODE))
def test_serve_decode_on_a_placed_cache_equals_the_plain_decode(worlds,
                                                                arch):
    """Greedy decode on a (2, 2) mesh as the dry run places it: the MoE's
    ``gather`` combine on DTensors; the enc-dec's cross-attention with
    heads that do not divide ``model`` (its q gathered, its K/V split
    over the sequence and attended in parts); the SSM step of mamba2 and
    of the hybrid computed where the cache is placed, its new state and
    conv window written in place. The logits equal the plain decode's at
    every step (fp32, 1e-5)."""
    _, outs = worlds[4]
    for o in outs:
        np.testing.assert_allclose(o[f"serve_decode/{arch}/got"],
                                   o[f"serve_decode/{arch}/want"],
                                   atol=1e-5, rtol=1e-5)


def test_attention_refuses_a_sharded_head_dim():
    class HeadDimSharded:
        def is_partial(self):
            return False

        def is_shard(self, dim=None):
            return dim is None or dim == 3

        dim = 3

    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, i=None):
            return 2

    class Q:
        device_mesh = Mesh()
        placements = (HeadDimSharded(),)
        shape = (2, 8, 4, 16)

    with pytest.raises(ValueError, match="batch, sequence and heads only"):
        L._sharded_attention(Q(), Q(), Q(), None, None, True, None,
                             L.ModelOptions())


# --------------------------------------------------------------------------
# the train step with grad_specs, and the launcher
# --------------------------------------------------------------------------

def test_a_remat_layer_on_a_mesh_replays_its_collectives(one_rank):
    """``lm.run_layer`` under remat with a DTensor input: the recompute
    in the backward runs none of the layer's collectives (it replays
    the forward's results, each once); a second backward through the
    same graph (``retain_graph``) runs them again; every gradient
    equals the layer's without remat."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import lm
    mesh = one_rank["dm"]

    def layer(cfg, lp, x):
        h = x.to_local() @ lp["w"]
        gather = getattr(funcol, "all_gather_single_autograd", None) \
            or funcol.all_gather_tensor_autograd       # (torch 2.11's name)
        g = gather(h, 0, (mesh, 1))
        g = g.wait() if isinstance(g, funcol.AsyncCollectiveTensor) else g
        return (g.tanh() @ lp["w"]).sum()

    class Gathers(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Gathers.n += "all_gather" in func.name()
            return func(*args, **(kwargs or {}))

    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(4, 8, generator=gen)
    w0 = torch.randn(8, 8, generator=gen)
    grads = {}
    for remat in (False, True):
        x = DTensor.from_local(x0.clone().requires_grad_(), mesh,
                               [Replicate(), Replicate()])
        w = w0.clone().requires_grad_()
        out = lm.run_layer(L.ModelOptions(remat=remat), layer, None,
                           {"w": w}, x)
        got = []
        for again in (0, 1):
            Gathers.n = 0
            with Gathers():
                got.append(torch.autograd.grad(out, w, retain_graph=True)[0])
            assert Gathers.n == (remat and again), (remat, again, Gathers.n)
        grads[remat] = got
    for g in grads[True] + grads[False][1:]:
        torch.testing.assert_close(g, grads[False][0], rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_train_step_equals_the_plain_step(one_rank, remat):
    """The smoke qwen2 step, parameters and moments placed as DTensors on
    the (1, 1) mesh (FSDP over ``data``, ZeRO-1 moments), attention
    through ``flash_torch`` with small blocks on the local shards: loss,
    gradient norm and every updated parameter equal the plain step's."""
    cfg = smoke_config(get_config("qwen2_1_5b"))
    opts = L.ModelOptions(dtype=torch.float32, attn_impl="flash_torch",
                          block_q=16, block_kv=16, remat=remat)
    params = build_model(cfg, opts).init(torch.Generator().manual_seed(0),
                                         "cpu")
    state = opt.init(params)
    toks = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    want_p, _, want = make_train_step(cfg, opts)(params, state, batch)

    mesh = one_rank["dm"]
    pspecs = sh.param_specs(params, mesh, fsdp_axes="data")
    ospecs = sh.zero1_specs(state, opt.state_specs(pspecs), mesh)
    dparams = sh.distribute_tree(params, pspecs, mesh)
    dstate = sh.distribute_tree(state, ospecs, mesh)
    step = make_train_step(cfg, opts, grad_specs=pspecs)
    with sh.use_mesh(mesh):
        got_p, got_s, got = step(dparams, dstate, batch)
    assert not sh.is_dtensor(got["loss"])
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    for (path, w), g in zip(leaf_paths(want_p), leaves(got_p)):
        assert sh.is_dtensor(g), path
        assert torch.equal(g.full_tensor(), w), path
    mu = leaves(got_s.mu)
    assert all(sh.is_dtensor(m) for m in mu)


def test_a_recorded_sharded_step_equals_the_plain_step(one_rank):
    """The program's spans record a step over DTensors as over plain
    tensors, and change none of its numbers."""
    from repro_torch import telemetry
    cfg = smoke_config(get_config("qwen2_1_5b"))
    opts = L.ModelOptions(dtype=torch.float32, attn_impl="flash_torch",
                          block_q=16, block_kv=16, remat=False)
    params = build_model(cfg, opts).init(torch.Generator().manual_seed(0),
                                         "cpu")
    state = opt.init(params)
    toks = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    with telemetry.recording() as plain:
        want_p, _, want = make_train_step(cfg, opts)(params, state, batch)
    mesh = one_rank["dm"]
    pspecs = sh.param_specs(params, mesh, fsdp_axes="data")
    ospecs = sh.zero1_specs(state, opt.state_specs(pspecs), mesh)
    step = make_train_step(cfg, opts, grad_specs=pspecs)
    with sh.use_mesh(mesh), telemetry.recording() as rec:
        got_p, _, got = step(sh.distribute_tree(params, pspecs, mesh),
                             sh.distribute_tree(state, ospecs, mesh), batch)
    assert torch.equal(got["loss"], want["loss"])
    for w, g in zip(leaves(want_p), leaves(got_p)):
        assert torch.equal(g.full_tensor(), w)
    names = [s.name for s in rec.spans]
    assert names[0] == "step.train" and {s.unit for s in rec.spans} == {0}
    for name in ("lm.layer", "attention.block_pairs", "attention.bwd"):
        assert names.count(name) == cfg.n_layers, name
    assert names.count("optimizer.update") == 1
    assert rec.counts[0]["host_sync"] == plain.counts[0]["host_sync"] == \
        cfg.n_layers


def test_grad_specs_need_a_mesh():
    cfg = smoke_config(get_config("qwen2_1_5b"))
    opts = L.ModelOptions(dtype=torch.float32, remat=False)
    params = build_model(cfg, opts).init(torch.Generator().manual_seed(0),
                                         "cpu")

    class Mesh:
        shape = {"data": 1, "model": 1}
        axis_names = ("data", "model")

    specs = sh.param_specs(params, Mesh())
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no mesh"):
        make_train_step(cfg, opts, grad_specs=specs)(
            params, opt.init(params), {"tokens": toks, "labels": toks})


def test_the_launcher_trains_on_the_cpu_when_asked():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env=ranks.child_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("done:")]
    assert done and "(2 steps)" in done[0], proc.stdout
    first = float(done[0].split()[2])
    vocab = smoke_config(get_config("qwen2_1_5b")).vocab
    assert abs(first - np.log(vocab)) < 1.0


def test_the_launcher_defaults_to_the_card():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train on it")
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        train.main(["--smoke", "--steps", "1"])
