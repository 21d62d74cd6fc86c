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
    jobs = {2: ["ring", "ep", "attention"], 4: ["ring", "ep"]}
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


def test_ring_attention_refuses_autograd(one_rank):
    q, k, v, pos = ranks.ring_inputs("fp32_causal_gqa")
    tq = torch.from_numpy(q).requires_grad_()
    tp = torch.from_numpy(pos)
    with sh.use_mesh(one_rank["cp"]), pytest.raises(RuntimeError,
                                                    match="no backward"):
        L.ring_attention(tq, torch.from_numpy(k), torch.from_numpy(v), tp,
                         tp, "cp")


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


def test_attention_refuses_a_sharded_sequence():
    class SeqSharded:
        def is_partial(self):
            return False

        def is_shard(self, dim=None):
            return dim is None or dim == 1

        dim = 1

    class Mesh:
        mesh_dim_names = ("cp",)

        def size(self, i=None):
            return 2

    class Q:
        device_mesh = Mesh()
        placements = (SeqSharded(),)
        shape = (2, 8, 4, 16)

    with pytest.raises(ValueError, match="batch and heads only"):
        L._sharded_attention(Q(), Q(), Q(), None, None, True, None,
                             L.ModelOptions())


# --------------------------------------------------------------------------
# the train step with grad_specs, and the launcher
# --------------------------------------------------------------------------

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
