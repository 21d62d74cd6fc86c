"""The port's executable model (``repro_torch.models`` and the serve
steps) against the reference's ``repro.models``: the same weights —
a reference parameter tree made from a seed and perturbed with numpy
noise so that norms, biases and layers differ, carried over by
``params_from_reference`` — and the same seeded tokens go through both.

Bars: layer functions 2e-5 (fp32, the reference's kernel bar); logits
of the whole model 1e-4 (two layers in fp32 summed in another order);
port decode against port forward 2e-3, the reference's own bar
(``tests/test_decode_consistency.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import ShapeConfig
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.models import api, layers as L, lm
from repro_torch.models.convert import params_from_reference
from repro_torch.train.step import make_prefill_step, make_serve_step

ARCHS = ["qwen2_1_5b",          # GQA, tied embeddings, qkv bias
         "h2o_danube_1_8b",     # sliding window (32 in the smoke config)
         "gpt2_345m"]           # GELU MLP
REF_IMPL = {"naive": "naive", "flash_torch": "flash_jnp", "cuda": "pallas"}
TOL = dict(atol=1e-4, rtol=1e-4)


def ref_opts(impl="naive"):
    return RL.ModelOptions(dtype=jnp.float32, remat=False,
                           attn_impl=REF_IMPL[impl], block_q=16,
                           block_kv=24)


def port_opts(impl="naive"):
    return L.ModelOptions(dtype=torch.float32, attn_impl=impl, block_q=16,
                          block_kv=24)


def configs(arch):
    ref_cfg = ref_smoke_config(ref_get_config(arch))
    cfg = smoke_config(get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


def reference_tree(ref_cfg, seed=0):
    """A reference parameter tree as numpy arrays, every leaf perturbed."""
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(seed),
                                ref_opts())
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(
            a.shape, dtype=np.float32)).astype(np.float32), params)


def both_params(ref_cfg, seed=0):
    tree = reference_tree(ref_cfg, seed)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_reference(tree, device="cpu"))


def tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(1, vocab, (b, s),
                                                dtype=np.int32)


def arr(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# --------------------------------------------------------------------------
# layer functions
# --------------------------------------------------------------------------

def test_layer_functions_match_the_reference():
    rng = np.random.default_rng(7)
    t, j = torch.from_numpy, jnp.asarray

    def close(p, r):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=2e-5)

    x, sc = arr(rng, 2, 5, 64), arr(rng, 64)
    close(L.rmsnorm(t(x), t(sc)), RL.rmsnorm(j(x), j(sc)))
    xr, pos = arr(rng, 2, 9, 4, 32), np.arange(9)[None].repeat(2, 0) + 3
    close(L.apply_rope(t(xr), t(pos), 1e4), RL.apply_rope(j(xr), j(pos),
                                                          1e4))
    wg, wu, wd = arr(rng, 64, 96), arr(rng, 64, 96), arr(rng, 96, 64)
    close(L.swiglu(t(x), t(wg), t(wu), t(wd)),
          RL.swiglu(j(x), j(wg), j(wu), j(wd)))
    b1, b2 = arr(rng, 96), arr(rng, 64)
    close(L.gelu_mlp(t(x), t(wg), t(b1), t(wd), t(b2)),
          RL.gelu_mlp(j(x), j(wg), j(b1), j(wd), j(b2)))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_attention_functions_match_the_reference(causal, window):
    rng = np.random.default_rng(8)
    q, k, v = arr(rng, 2, 70, 4, 16), arr(rng, 2, 70, 2, 16), \
        arr(rng, 2, 70, 2, 16)
    pos = np.arange(70)[None].repeat(2, 0)
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, pos))
    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, k, v, pos))
    naive = L.attention_naive(tq, tk, tv, tp, tp, causal, window)
    np.testing.assert_allclose(
        naive.numpy(),
        np.asarray(RL.attention_naive(jq, jk, jv, jp, jp, causal, window)),
        atol=2e-5, rtol=2e-5)
    flash = L.attention_flash_torch(tq, tk, tv, tp, tp, causal, window,
                                    block_q=32, block_kv=24)
    np.testing.assert_allclose(
        flash.numpy(),
        np.asarray(RL.attention_flash_jnp(jq, jk, jv, jp, jp, causal, window,
                                          block_q=32, block_kv=24)),
        atol=2e-5, rtol=2e-5)
    # decode: one query at position 50 over a cache with empty slots
    kpos = pos.copy()
    kpos[:, 60:] = 2 ** 30
    qd = q[:, 50:51]
    dec = L.attention_decode(torch.from_numpy(qd), tk, tv, tp[:, 50:51],
                             torch.from_numpy(kpos), window)
    np.testing.assert_allclose(
        dec.numpy(),
        np.asarray(RL.attention_decode(jnp.asarray(qd), jk, jv, jp[:, 50:51],
                                       jnp.asarray(kpos), window)),
        atol=2e-5, rtol=2e-5)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["naive", "flash_torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch, impl):
    """Port ``naive`` vs reference ``naive``, ``flash_torch`` vs
    ``flash_jnp``, ``cuda`` (its plain version on the CPU) vs
    ``pallas`` (interpret mode), through the prefill step."""
    ref_cfg, cfg = configs(arch)
    jp, tp = both_params(ref_cfg)
    toks = tokens(cfg.vocab, 2, 48)
    want = ref_lm.forward(ref_cfg, jp, {"tokens": jnp.asarray(toks)},
                          ref_opts(impl))
    got = make_prefill_step(cfg, port_opts(impl))(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 48, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vlm_forward_with_patch_embeddings():
    ref_cfg, cfg = configs("qwen2_vl_72b")
    jp, tp = both_params(ref_cfg)
    toks = tokens(cfg.vocab, 2, 20)
    patches = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model), dtype=np.float32)
    want = ref_lm.forward(ref_cfg, jp, {"tokens": jnp.asarray(toks),
                                        "patch_embeds": jnp.asarray(patches)},
                          ref_opts())
    got = lm.forward(cfg, tp, {"tokens": torch.from_numpy(toks),
                               "patch_embeds": torch.from_numpy(patches)},
                     port_opts())
    assert got.shape == (2, 32, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_forward(arch):
    """48 tokens one at a time (the window-32 ring buffer wraps): each
    step's logits against the reference's decode step, and against the
    port's own teacher-forced forward."""
    ref_cfg, cfg = configs(arch)
    jp, tp = both_params(ref_cfg, seed=3)
    b, s = 2, 48
    toks = tokens(cfg.vocab, b, s, seed=4)
    full = make_prefill_step(cfg, port_opts())(
        tp, {"tokens": torch.from_numpy(toks)})

    ref_step = jax.jit(ref_api.build_model(ref_cfg, ref_opts()).decode_step)
    ref_cache = ref_lm.init_cache(ref_cfg, b, s, ref_opts())
    step = make_serve_step(cfg, port_opts())
    cache = lm.init_cache(cfg, b, s, port_opts(), device="cpu")
    if cfg.sliding_window:
        assert cache["attn"]["k"].shape[2] == cfg.sliding_window < s
    for i in range(s):
        tok = toks[:, i:i + 1]
        want, ref_cache = ref_step(jp, ref_cache, {"tokens": jnp.asarray(tok)})
        got, cache = step(tp, cache, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{arch}: step {i} vs reference")
        np.testing.assert_allclose(got.numpy(), full[:, i].numpy(),
                                   atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch}: step {i} vs forward")
    assert cache["pos"].tolist() == [s, s]


# --------------------------------------------------------------------------
# parameters, specs, families, devices
# --------------------------------------------------------------------------

def test_bf16_reference_tree_converts_bit_exact():
    ref_cfg, _ = configs("h2o_danube_1_8b")
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(5),
                                RL.ModelOptions(dtype=jnp.bfloat16))
    tree = jax.tree.map(np.asarray, params)
    assert tree["embed"].dtype.name == "bfloat16"
    out = params_from_reference(tree, device="cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_ref) == len(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: 0, out)))
    for path, a in flat_ref:
        node = out
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == a.shape
        np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                      a.view(np.int16))
    cast = params_from_reference(tree, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(cast["embed"].numpy(),
                                  tree["embed"].astype(np.float32))


def test_init_params_shapes_and_distribution():
    ref_cfg, cfg = configs("qwen2_1_5b")
    ref = jax.tree.map(np.asarray, ref_lm.init_params(
        ref_cfg, jax.random.PRNGKey(0), ref_opts()))
    gen = torch.Generator().manual_seed(0)
    got = lm.init_params(cfg, gen, device="cpu", opts=port_opts())

    def walk(r, p):
        assert set(r) == set(p)
        for k in r:
            if isinstance(r[k], dict):
                walk(r[k], p[k])
                continue
            assert tuple(p[k].shape) == r[k].shape, k
            if r[k].ndim <= 2 and k != "embed":     # stacked 1-D: ones/zeros
                np.testing.assert_array_equal(p[k].numpy(), r[k])
    walk(ref, got)
    wq = got["attn_layers"]["wq"]
    assert torch.equal(wq[0], wq[1])        # one draw over the stack
    assert abs(float(wq.std()) - 0.02) < 2e-3


@pytest.mark.parametrize("kind,seq,batch", [("train", 64, 2),
                                             ("prefill", 64, 2),
                                             ("decode", 40, 3)])
@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "qwen2_vl_72b"])
def test_input_specs_and_make_batch_match_the_reference(arch, kind, seq,
                                                        batch):
    ref_cfg, cfg = configs(arch)
    shape = ShapeConfig("s", seq, batch, kind)
    want = ref_api.input_specs(ref_cfg, shape, ref_opts())
    got = api.input_specs(cfg, shape, port_opts())
    flat = jax.tree_util.tree_leaves_with_path(want)
    made = api.make_batch(cfg, shape, torch.Generator().manual_seed(0),
                          device="cpu", opts=port_opts())
    n = 0
    for path, spec in flat:
        node, real = got, made
        for key in path:
            node, real = node[key.key], real[key.key]
        assert node.shape == spec.shape
        assert str(node.dtype).split(".")[-1] == str(spec.dtype)
        assert tuple(real.shape) == spec.shape and real.dtype == node.dtype
        n += 1
    assert n == len(jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, api.TensorSpec)))


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mamba2_2_7b",
                                  "jamba_v0_1_52b", "whisper_tiny"])
def test_every_family_builds(arch):
    """Every family builds and initialises; their parity with the
    reference is in ``test_torch_families.py``."""
    cfg = smoke_config(get_config(arch))
    params = api.build_model(cfg, port_opts()).init(torch.Generator(),
                                                    device="cpu")
    assert params["embed"].shape == (cfg.vocab, cfg.d_model)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=`` every entry point asks for CUDA and raises on
    a host without it; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs("h2o_danube_1_8b")
    gen = torch.Generator()
    shape = ShapeConfig("s", 16, 2, "prefill")
    calls = [lambda: lm.init_params(cfg, gen),
             lambda: lm.init_cache(cfg, 2, 16),
             lambda: api.build_model(cfg).init(gen),
             lambda: api.build_model(cfg).init_cache(2, 16),
             lambda: api.make_batch(cfg, shape, gen),
             lambda: params_from_reference({"embed": np.zeros((2, 2))})]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda is not available"):
            call()


def test_scenario_shape_matches_the_reference():
    from repro.core.scenario import Decode as RefDecode
    from repro_torch.core.scenario import Decode
    want = ref_api.scenario_shape(RefDecode(steps=4, context=100), 8, 512)
    got = api.scenario_shape(Decode(steps=4, context=100), 8, 512)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
