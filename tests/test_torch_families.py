"""The port's MoE, SSM, hybrid and encoder-decoder families
(``repro_torch.models.{moe, ssm, lm, encdec}``) against the reference's
``repro.models``, at smoke size: the same weights — a reference
parameter tree made from a seed and perturbed with numpy noise, carried
over by ``params_from_reference`` — and the same seeded inputs go
through both.

Bars (fp32): forward logits 1e-4 (several layers summed in another
order), the loss 1e-5, train-step gradients 2e-5 × max|g| per leaf (the
bars of ``test_torch_models.py`` and ``test_torch_train.py``); decode
against the reference's decode, and decode == forward, at 2e-3, the
reference's own bar (``tests/test_decode_consistency.py``), MoE at its
dropless capacity where decode == forward is well defined. The
``cuda`` attention runs its plain version on these CPU tensors and is
held against the reference's Pallas kernel in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro.models import layers as RL
from repro.models import moe as ref_moe
from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
from repro_torch.models import api, encdec, layers as L, lm, moe
from repro_torch.models.convert import params_from_reference
from repro_torch.train import step as step_mod
from repro_torch.train.tree import leaf_paths

FAMILIES = ["qwen3_moe_30b_a3b",     # MoE, GQA
            "dbrx_132b",             # MoE, wider experts
            "mamba2_2_7b",           # SSM
            "jamba_v0_1_52b",        # hybrid: attention + SSM, MoE + dense
            "t5_large",              # enc-dec, token encoder
            "whisper_tiny"]          # enc-dec, audio stub, qkv bias
ATTN = [a for a in FAMILIES if a != "mamba2_2_7b"]
REF_IMPL = {"naive": "naive", "flash_torch": "flash_jnp", "cuda": "pallas"}
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 24


def ref_opts(impl="naive", moe_impl="gather"):
    return RL.ModelOptions(dtype=jnp.float32, remat=False,
                           attn_impl=REF_IMPL[impl], block_q=16,
                           block_kv=24, moe_impl=moe_impl)


def port_opts(impl="naive", moe_impl="gather", remat=False):
    return L.ModelOptions(dtype=torch.float32, attn_impl=impl, block_q=16,
                          block_kv=24, moe_impl=moe_impl, remat=remat)


def dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=ref_moe.dropless_capacity_factor(cfg.moe)))


def configs(arch, drop=False):
    ref_cfg = ref_smoke_config(ref_get_config(arch))
    cfg = smoke_config(get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    if drop:
        ref_cfg, cfg = dropless(ref_cfg), dropless(cfg)
    return ref_cfg, cfg


def reference_tree(ref_cfg, seed=0):
    """A reference parameter tree as numpy arrays, every leaf perturbed
    so that norms, biases, SSM ramps and layers differ."""
    params = ref_api.build_model(ref_cfg, ref_opts()).init(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(
            a.shape, dtype=np.float32)).astype(np.float32), params)


def batch_for(cfg, b=B, s=S, seed=1, frames=16):
    """Seeded tokens and next-token labels (a few -1); an enc-dec model
    also gets its encoder input: ``frames`` tokens or frame
    embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (b, s), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[rng.integers(0, b, 3), rng.integers(0, s, 3)] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.enc_dec:
        if cfg.audio_stub:
            batch["frame_embeds"] = rng.standard_normal(
                (b, frames, cfg.d_model), dtype=np.float32)
        else:
            batch["tokens_enc"] = rng.integers(1, cfg.vocab, (b, frames),
                                               dtype=np.int32)
    return batch


def to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


#: a leaf whose gradient is zero in exact arithmetic — the key bias of
#: a cross-attention without RoPE adds one constant to a row's scores,
#: which the softmax cancels — holds rounding noise in both packages,
#: below this share of the largest gradient
ZERO_SHARE = 1e-6


def assert_leaves_close(got, want, rel=2e-5):
    """Each leaf within ``rel`` x max|leaf| of the reference's; a leaf
    that is zero up to rounding in the reference must be so in the port
    too."""
    got = {p: v for p, v in leaf_paths(got)}
    want = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = got[name].detach().float().numpy()
        scale = float(np.abs(w).max())
        if scale < ZERO_SHARE * top:
            assert float(np.abs(g).max()) < ZERO_SHARE * top, name
            continue
        assert np.abs(g - w).max() <= rel * scale, \
            (name, float(np.abs(g - w).max()), scale)


# --------------------------------------------------------------------------
# forward, loss, gradients
# --------------------------------------------------------------------------

CASES = [(a, "naive") for a in FAMILIES] + \
    [(a, i) for a in ATTN for i in ("flash_torch", "cuda")]


@pytest.mark.parametrize("arch,impl", CASES)
def test_forward_logits_match_the_reference(arch, impl):
    ref_cfg, cfg = configs(arch)
    tree = reference_tree(ref_cfg)
    batch = batch_for(cfg)
    want = ref_api.build_model(ref_cfg, ref_opts(impl)).forward(
        jax.tree.map(jnp.asarray, tree), to_ref(batch))
    got = api.build_model(cfg, port_opts(impl)).forward(
        params_from_reference(tree, device="cpu"), to_port(batch))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "jamba_v0_1_52b"])
def test_dense_dispatch_matches_the_reference(arch):
    ref_cfg, cfg = configs(arch)
    tree = reference_tree(ref_cfg, seed=2)
    batch = batch_for(cfg, seed=3)
    want = ref_api.build_model(ref_cfg, ref_opts(
        moe_impl="dense_dispatch")).forward(
        jax.tree.map(jnp.asarray, tree), to_ref(batch))
    got = api.build_model(cfg, port_opts(moe_impl="dense_dispatch")).forward(
        params_from_reference(tree, device="cpu"), to_port(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_the_reference(arch):
    """The loss with the MoE router's aux term (0.01 × aux)."""
    ref_cfg, cfg = configs(arch)
    tree = reference_tree(ref_cfg, seed=4)
    batch = batch_for(cfg, seed=5)
    want = ref_api.build_model(ref_cfg, ref_opts()).loss(
        jax.tree.map(jnp.asarray, tree), to_ref(batch))
    got = api.build_model(cfg, port_opts()).loss(
        params_from_reference(tree, device="cpu"), to_port(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,impl", [(a, "naive") for a in FAMILIES]
                         + [("jamba_v0_1_52b", "flash_torch"),
                            ("t5_large", "flash_torch")])
def test_train_step_gradients_match_jax_grad(arch, impl):
    ref_cfg, cfg = configs(arch)
    tree = reference_tree(ref_cfg, seed=6)
    batch = batch_for(cfg, seed=7)
    ref_model = ref_api.build_model(ref_cfg, ref_opts(impl))
    want = jax.grad(lambda p: ref_model.loss(p, to_ref(batch)))(
        jax.tree.map(jnp.asarray, tree))
    loss, got = step_mod.value_and_grad(
        api.build_model(cfg, port_opts(impl, remat=True)).loss,
        params_from_reference(tree, device="cpu"), to_port(batch))
    assert_leaves_close(got, want)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _caches(arch, ref_cfg, cfg, tree, batch, b, s):
    """Fresh decode caches of both packages (an enc-dec one with its
    cross K/V precomputed from an encoder pass)."""
    ref_model = ref_api.build_model(ref_cfg, ref_opts())
    model = api.build_model(cfg, port_opts())
    rc, pc = ref_model.init_cache(b, s), model.init_cache(b, s, "cpu")
    if cfg.enc_dec:
        rp = jax.tree.map(jnp.asarray, tree)
        pp = params_from_reference(tree, device="cpu")
        key = "frame_embeds" if cfg.audio_stub else "tokens_enc"
        r_in = to_ref(batch)[key]
        p_in = to_port(batch)[key]
        if not cfg.audio_stub:
            r_in, p_in = rp["embed"][r_in], pp["embed"][p_in.long()]
        r_enc = ref_encdec.encode(ref_cfg, rp, r_in, ref_opts())
        p_enc = encdec.encode(cfg, pp, p_in, port_opts())
        ck, cv = ref_encdec.precompute_cross(ref_cfg, rp, r_enc)
        rc = {**rc, "cross_k": ck, "cross_v": cv}
        pk, pv = encdec.precompute_cross(cfg, pp, p_enc)
        pc = {**pc, "cross_k": pk, "cross_v": pv}
    return rc, pc


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_reference_and_forward(arch):
    """Token by token, the port's decode equals the reference's decode
    and the port's own forward (MoE at its dropless capacity)."""
    ref_cfg, cfg = configs(arch, drop=True)
    tree = reference_tree(ref_cfg, seed=8)
    b, s = 2, 12
    batch = batch_for(cfg, b, s, seed=9, frames=8)
    batch.pop("labels")
    params = params_from_reference(tree, device="cpu")
    model = api.build_model(cfg, port_opts())
    full = model.forward(params, to_port(batch))
    rc, pc = _caches(arch, ref_cfg, cfg, tree, batch, b, s)
    rp = jax.tree.map(jnp.asarray, tree)
    ref_step = jax.jit(ref_api.build_model(ref_cfg, ref_opts()).decode_step)
    for t in range(s):
        tok = batch["tokens"][:, t:t + 1]
        want, rc = ref_step(rp, rc, {"tokens": jnp.asarray(tok)})
        got, pc = model.decode_step(params, pc,
                                    {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch} vs reference at {t}")
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch} vs forward at {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_reference_cache_converts_and_decodes_on(dtype):
    """A hybrid decode cache the reference has advanced (attention ring
    buffers and ``SSMCache`` states, bf16 leaves through their
    ``uint16`` view) carries over bit for bit, and the port's decode
    continues from it as the reference's does: 2e-3 in fp32, 2e-2 in
    bf16 (the reference's bf16 kernel bar)."""
    ref_cfg, cfg = configs("jamba_v0_1_52b", drop=True)
    tree = reference_tree(ref_cfg, seed=10)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ropts = dataclasses.replace(ref_opts(), dtype=jdt)
    ref_model = ref_api.build_model(ref_cfg, ropts)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree)
    toks = batch_for(cfg, 2, 4, seed=11)["tokens"]
    rc = ref_model.init_cache(2, 8)
    for t in range(3):
        _, rc = ref_model.decode_step(rp, rc, {"tokens": jnp.asarray(
            toks[:, t:t + 1])})
    pc = params_from_reference(jax.tree.map(np.asarray, rc), device="cpu")
    assert isinstance(pc["ssm_dense"], type(
        api.build_model(cfg).init_cache(2, 8, "meta")["ssm_dense"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(rc):
        node = pc
        for k in path:
            node = node[k.key] if hasattr(k, "key") else getattr(node, k.name)
        want = np.asarray(leaf)
        if str(want.dtype) == "bfloat16":
            want, node = want.view(np.int16), node.view(torch.int16)
        np.testing.assert_array_equal(node.numpy(), want)
    pp = params_from_reference(tree, device="cpu", dtype=tdt)
    model = api.build_model(cfg, dataclasses.replace(port_opts(), dtype=tdt))
    want, _ = ref_model.decode_step(rp, rc, {"tokens": jnp.asarray(
        toks[:, 3:4])})
    got, _ = model.decode_step(pp, pc, {"tokens": torch.from_numpy(
        toks[:, 3:4])})
    tol = 2e-3 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_ssm_decode_updates_the_cache_in_place():
    _, cfg = configs("jamba_v0_1_52b")
    model = api.build_model(cfg, port_opts())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cache = model.init_cache(2, 8, "cpu")
    states = [cache[k].state for k in ("ssm_moe", "ssm_dense") if k in cache]
    _, out = model.decode_step(params, cache,
                               {"tokens": torch.ones((2, 1), dtype=torch.int32)})
    for st in states:
        assert float(st.abs().max()) > 0
    assert all(out[k].state is cache[k].state
               for k in ("ssm_moe", "ssm_dense") if k in cache)
    assert out["pos"].tolist() == [1, 1]


# --------------------------------------------------------------------------
# shapes, specs and init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_param_shapes_and_specs_match_the_reference(arch):
    ref_cfg, cfg = configs(arch)
    want = ref_api.build_model(ref_cfg, ref_opts()).init(
        jax.random.PRNGKey(0))
    got = api.build_model(cfg, port_opts()).init(
        torch.Generator().manual_seed(0), "cpu")
    want_shapes = {"/".join(k.key for k in p): tuple(v.shape)
                   for p, v in jax.tree_util.tree_leaves_with_path(want)}
    assert {p: tuple(v.shape) for p, v in leaf_paths(got)} == want_shapes
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", 32, 2, kind)
        from repro.configs.base import ShapeConfig as RefShape
        rs = ref_api.input_specs(ref_cfg, RefShape("s", 32, 2, kind),
                                 ref_opts())
        ps = api.input_specs(cfg, shape, port_opts())
        flat = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in p): tuple(v.shape)
                for p, v in jax.tree_util.tree_leaves_with_path(rs)}
        got_specs = {}

        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, prefix + (k,))
            elif isinstance(node, api.TensorSpec):
                got_specs["/".join(prefix)] = node.shape
            else:                               # an SSMCache of specs
                for f, v in zip(node._fields, node):
                    walk(v, prefix + (f,))
        walk(ps, ())
        assert got_specs == flat, kind
        made = api.make_batch(cfg, shape, torch.Generator().manual_seed(1),
                              "cpu", port_opts())
        assert set(made) == set(ps)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "jamba_v0_1_52b"])
def test_ssm_init_ramps_are_the_references(arch):
    """``dt_bias``, ``A_log`` and ``D`` are deterministic in the
    reference's init; the port draws the same values."""
    ref_cfg, cfg = configs(arch)
    want = ref_api.build_model(ref_cfg, ref_opts()).init(
        jax.random.PRNGKey(0))
    got = api.build_model(cfg, port_opts()).init(
        torch.Generator().manual_seed(0), "cpu")
    kind = "ssm_layers" if "ssm_layers" in got else "ssm_dense_layers"
    for name in ("dt_bias", "A_log", "D", "norm_scale", "conv_b"):
        np.testing.assert_allclose(got[kind][name].numpy(),
                                   np.asarray(want[kind][name]),
                                   rtol=1e-6, atol=1e-7)


def test_ep_a2a_needs_a_process_group():
    _, cfg = configs("qwen3_moe_30b_a3b")
    model = api.build_model(cfg, port_opts(moe_impl="ep_a2a"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    # ep_a2a runs over the current mesh's process group; without a mesh
    # it raises (tests/test_torch_parallel.py runs it on one)
    with pytest.raises(RuntimeError, match="no mesh"):
        model.forward(params, to_port({"tokens": np.ones((1, 4), np.int32)}))
    with pytest.raises(ValueError):
        moe.moe_ffn(torch.zeros((1, 4, cfg.d_model)), None, cfg.moe, "nope")
