"""The port's training path (``repro_torch.models`` loss and flash
backward, ``repro_torch.train``) against the reference's ``repro.train``
on the same inputs: seeded numpy arrays, and reference parameters (and
AdamW states) carried over by ``models.convert``.

Bars (fp32): flash-attention gradients 2e-5, as the reference's kernel
tests; the loss 1e-5; train-step gradients 2e-5 x max|g| per leaf (two
backward passes summed in another order); AdamW on identical gradients
rtol 1e-6, with 1e-6 x max|leaf| absolute where a parameter and its
step cancel (elementwise fp32 arithmetic in the reference's order). The
substrate cases of ``tests/test_train_substrate.py`` run over both
packages where the check is the same. Nothing here times anything: the
check that the simulator predicts a real step runs on the card only
(``gpu`` marker, and ``chip_smoke.py``).
"""
import dataclasses
import math
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.train import fault_tolerance as ref_ft
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import api, layers as L, lm
from repro_torch.models.convert import (optimizer_state_from_reference,
                                        params_from_reference)
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod
from repro_torch.train.train_loop import LoopConfig, fit
from repro_torch.train.tree import leaf_paths

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)


def arr(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def configs(arch):
    ref_cfg = ref_smoke_config(ref_get_config(arch))
    cfg = smoke_config(get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


def ref_opts(impl="naive", remat=False):
    return RL.ModelOptions(dtype=jnp.float32, remat=remat,
                           attn_impl={"naive": "naive",
                                      "flash_torch": "flash_jnp"}[impl],
                           block_q=64, block_kv=96)


def port_opts(impl="naive", remat=False):
    return L.ModelOptions(dtype=torch.float32, attn_impl=impl, remat=remat,
                          block_q=64, block_kv=96)


def reference_tree(ref_cfg, seed=0):
    """A reference parameter tree as numpy arrays, every leaf perturbed
    so that norms and layers differ."""
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(seed),
                                ref_opts())
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(
            a.shape, dtype=np.float32)).astype(np.float32), params)


def lm_batch(vocab, b, s, seed=1, n_unlabelled=5):
    """Seeded tokens and next-token labels, a few labels -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, s), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[rng.integers(0, b, n_unlabelled),
           rng.integers(0, s, n_unlabelled)] = -1
    return {"tokens": toks, "labels": labels}


def to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def by_path(tree):
    return {p: v for p, v in leaf_paths(tree)}


def ref_by_path(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_leaves_close(got, want, rel=2e-5):
    """Each leaf within ``rel`` x max|leaf| of the reference's."""
    got, want = by_path(got), ref_by_path(want)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach().float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= rel * scale, \
            (name, float(np.abs(g - w).max()), scale)


# --------------------------------------------------------------------------
# the flash backward
# --------------------------------------------------------------------------

FLASH_CASES = {
    # B, S, H, KH, hd, causal, window, block_q, block_kv
    "causal": (2, 70, 4, 2, 16, True, None, 32, 24),
    "window": (2, 70, 4, 2, 16, True, 24, 32, 24),
    "non-causal": (2, 70, 4, 4, 16, False, None, 32, 24),
    "gqa-n_rep-4": (1, 96, 8, 2, 16, True, 40, 32, 32),
    "ragged-window": (2, 53, 4, 1, 8, True, 17, 16, 12),
}


def flash_inputs(case, seed=0):
    b, s, h, kh, hd = FLASH_CASES[case][:5]
    rng = np.random.default_rng(seed)
    return (arr(rng, b, s, h, hd), arr(rng, b, s, kh, hd),
            arr(rng, b, s, kh, hd), arr(rng, b, s, h, hd),
            np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy())


def port_flash_grads(case, impl):
    causal, window, bq, bkv = FLASH_CASES[case][5:]
    q, k, v, cot, pos = flash_inputs(case)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    p = torch.from_numpy(pos)
    if impl == "flash_torch":
        out = L.attention_flash_torch(q, k, v, p, p, causal, window, bq, bkv)
    else:
        out = L.attention_naive(q, k, v, p, p, causal, window)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_jax_grad_of_the_reference(case):
    causal, window, bq, bkv = FLASH_CASES[case][5:]
    q, k, v, cot, pos = flash_inputs(case)
    jp = jnp.asarray(pos)

    def f(q, k, v):
        out = RL.attention_flash_jnp(q, k, v, jp, jp, causal, window, bq,
                                     bkv)
        return jnp.sum(out * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, got = port_flash_grads(case, "flash_torch")
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **ATTN_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_naive_autograd(case):
    out, got = port_flash_grads(case, "flash_torch")
    out_naive, want = port_flash_grads(case, "naive")
    np.testing.assert_allclose(out.numpy(), out_naive.numpy(), **ATTN_TOL)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, **ATTN_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_bf16_flash_backward_rounds_where_the_reference_rounds(case):
    """In bf16 the backward rounds at the reference's points: ds scaled
    before its cast, each query head's dk, dv cast before the heads of a
    KV head are added up in bf16. What is left are fp32 results a ulp
    apart (GEMM sums in another order, exp, the scaled-score add) that
    flip a few bf16 roundings, far below the reference's own bf16 error
    (rounding ds unscaled, or summing the heads in fp32 first, leaves
    the port about as far from the reference as the reference is from
    fp32)."""
    causal, window, bq, bkv = FLASH_CASES[case][5:]
    q, k, v, cot, pos = flash_inputs(case)
    q, k, v, cot = (np.asarray(jnp.asarray(a, jnp.bfloat16))
                    for a in (q, k, v, cot))
    jpos = jnp.asarray(pos)

    def ref_loss(q, k, v):
        out = RL.attention_flash_jnp(q, k, v, jpos, jpos, causal, window,
                                     bq, bkv)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.asarray(cot, jnp.float32))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    exact = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    tq, tk, tv = (params_from_reference({"x": a}, device="cpu")["x"]
                  .requires_grad_() for a in (q, k, v))
    p = torch.from_numpy(pos)
    out = L.attention_flash_torch(tq, tk, tv, p, p, causal, window, bq, bkv)
    (out.float() * torch.from_numpy(cot.astype(np.float32))).sum() \
        .backward()
    for name, t, w, e in zip("qkv", (tq, tk, tv), want, exact):
        assert t.grad.dtype == torch.bfloat16
        g, w, e = (t.grad.float().numpy(), np.asarray(w, np.float32),
                   np.asarray(e))
        d_port = np.linalg.norm(g - w)
        d_ref = np.linalg.norm(w - e)
        assert d_port <= 0.05 * d_ref, (name, float(d_port), float(d_ref))


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_skipped_and_unmasked_block_pairs_change_no_bit(case):
    """Pairs the masks empty are skipped and pairs they leave whole go
    unmasked: the forward is bit-identical to masking every pair."""
    causal, window, bq, bkv = FLASH_CASES[case][5:]
    q, k, v, _, pos = flash_inputs(case)
    n_rep = q.shape[2] // k.shape[2]
    q, k, v, p = (torch.from_numpy(a) for a in (q, k, v, pos))
    q = L._heads(q, 1, bq)
    k, v = L._heads(k, n_rep, bkv), L._heads(v, n_rep, bkv)
    pairs = L._block_pairs(p, p, causal, window, bq, bkv)
    every = [[L.PARTIAL] * len(r) for r in pairs]
    kinds = {x for r in pairs for x in r}
    assert (L.SKIP in kinds) == causal and L.PARTIAL in kinds
    assert (L.FULL in kinds) == (case in ("causal", "non-causal"))
    s = pos.shape[1]                 # padded rows attend to nothing
    for got, want in zip(
            L._flash_fwd_impl(q, k, v, p, p, causal, window, bq, bkv, pairs),
            L._flash_fwd_impl(q, k, v, p, p, causal, window, bq, bkv,
                              every)):
        assert torch.equal(got[:, :, :s], want[:, :, :s])


def test_block_pairs_never_skip_a_pair_with_a_valid_entry():
    rng = np.random.default_rng(3)
    for _ in range(20):
        b, sq, sk = 2, int(rng.integers(1, 60)), int(rng.integers(1, 60))
        qp = torch.from_numpy(rng.integers(0, 80, (b, sq)))
        kp = torch.from_numpy(rng.integers(0, 80, (b, sk)))
        causal, window = bool(rng.integers(2)), [None, 7][rng.integers(2)]
        bq, bkv = int(rng.integers(1, 20)), int(rng.integers(1, 20))
        pairs = L._block_pairs(qp, kp, causal, window, bq, bkv)
        qb, kb = L._blockify(qp, bq, -1), L._blockify(kp, bkv, 2 ** 30)
        for i, row in enumerate(pairs):
            for j, kind in enumerate(row):
                m = L._block_mask(qb[i], kb[j], causal, window)
                if kind == L.SKIP:
                    assert not bool(m.any())
                if kind == L.FULL:
                    assert bool(m.all())


def test_attention_dispatch_trains_through_flash_torch():
    """``auto`` above the threshold is ``flash_torch``: its output has a
    ``grad_fn`` of the Function, not of the blockwise loop."""
    q, k, v, _, pos = flash_inputs("causal")
    q = torch.from_numpy(q).requires_grad_()
    p = torch.from_numpy(pos)
    out = L.attention(q, torch.from_numpy(k), torch.from_numpy(v), p, p,
                      opts=L.ModelOptions(flash_threshold=8))
    assert type(out.grad_fn).__name__ == "_FlashCoreBackward"


# --------------------------------------------------------------------------
# loss_fn and the gradients of the train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["naive", "flash_torch"])
def test_loss_matches_the_reference_dense(impl):
    """S = 700: the chunked CE pads its last chunk; some labels -1."""
    ref_cfg, cfg = configs("h2o_danube_1_8b")
    tree = reference_tree(ref_cfg)
    batch = lm_batch(cfg.vocab, 2, 700)
    want = ref_lm.loss_fn(ref_cfg, jax.tree.map(jnp.asarray, tree),
                          to_ref(batch), ref_opts(impl))
    got = lm.loss_fn(cfg, params_from_reference(tree, device="cpu"),
                     to_port(batch), port_opts(impl))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_loss_matches_the_reference_vlm_prefix():
    """qwen2_vl smoke: 12 patch positions carry no label."""
    ref_cfg, cfg = configs("qwen2_vl_72b")
    tree = reference_tree(ref_cfg)
    batch = lm_batch(cfg.vocab, 2, 40)
    batch["patch_embeds"] = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model), dtype=np.float32)
    want = ref_lm.loss_fn(ref_cfg, jax.tree.map(jnp.asarray, tree),
                          to_ref(batch), ref_opts())
    got = api.build_model(cfg, port_opts()).loss(
        params_from_reference(tree, device="cpu"), to_port(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,impl", [("h2o_danube_1_8b", "flash_torch"),
                                       ("qwen2_1_5b", "naive"),
                                       ("gpt2_345m", "naive")])
def test_train_step_gradients_match_jax_grad(arch, impl):
    ref_cfg, cfg = configs(arch)
    tree = reference_tree(ref_cfg, seed=4)
    batch = lm_batch(cfg.vocab, 2, 150, seed=5)
    want = jax.grad(lambda p: ref_lm.loss_fn(ref_cfg, p, to_ref(batch),
                                             ref_opts(impl)))(
        jax.tree.map(jnp.asarray, tree))
    loss, got = step_mod.value_and_grad(
        api.build_model(cfg, port_opts(impl)).loss,
        params_from_reference(tree, device="cpu"), to_port(batch))
    assert loss.grad_fn is None
    assert_leaves_close(got, want)


def bf16_opts(impl):
    return (dataclasses.replace(ref_opts(impl), dtype=jnp.bfloat16),
            dataclasses.replace(port_opts(impl), dtype=torch.bfloat16))


@pytest.mark.parametrize("arch,impl", [("h2o_danube_1_8b", "flash_torch"),
                                       ("qwen2_1_5b", "naive"),
                                       ("gpt2_345m", "naive")])
def test_bf16_train_step_gradients_round_as_the_reference(arch, impl):
    """bf16 gradients through ``make_train_step``'s ``value_and_grad``
    against ``jax.grad`` of the reference in bf16, on the same bf16
    weights. Two bf16 paths differ by far more than fp32 ulps, so the bar
    is relative, as the bf16 logits': per leaf, the port's distance from
    the fp32 gradients is at most 1.5 x the reference's. The distance
    is the L2 norm of the difference: a leaf's max |difference| is one
    element at one or two bf16 ulps, a count too coarse to compare."""
    ref_cfg, cfg = configs(arch)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        reference_tree(ref_cfg, seed=4))
    batch = lm_batch(cfg.vocab, 2, 150, seed=5)
    ref16, port16 = bf16_opts(impl)
    exact = ref_by_path(jax.grad(
        lambda p: ref_lm.loss_fn(ref_cfg, p, to_ref(batch),
                                 ref_opts(impl)))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)))
    want = ref_by_path(jax.grad(
        lambda p: ref_lm.loss_fn(ref_cfg, p, to_ref(batch), ref16))(
        jax.tree.map(jnp.asarray, tree)))
    _, grads = step_mod.value_and_grad(
        api.build_model(cfg, port16).loss,
        params_from_reference(tree, device="cpu"), to_port(batch))
    got = by_path(grads)
    assert set(got) == set(want) == set(exact)
    for name, e in exact.items():
        assert got[name].dtype == torch.bfloat16
        d_port = np.linalg.norm(got[name].float().numpy() - e)
        d_ref = np.linalg.norm(want[name].astype(np.float32) - e)
        assert d_port <= 1.5 * d_ref, (name, float(d_port), float(d_ref))


def test_a_leaf_the_loss_never_reaches_gets_zeros():
    """``jax.value_and_grad`` gives zeros for a leaf the loss skips;
    ``value_and_grad`` does the same instead of raising."""
    rng = np.random.default_rng(8)
    tree = {"a": arr(rng, 3, 4), "unused": arr(rng, 5),
            "nested": {"b": arr(rng, 4), "skipped": arr(rng, 2, 2)}}
    x = arr(rng, 2, 3)

    def ref_loss(p, x):
        return jnp.sum(jnp.tanh(x @ p["a"]) * p["nested"]["b"])

    def port_loss(p, x):
        return torch.sum(torch.tanh(x @ p["a"]) * p["nested"]["b"])

    rloss, rgrads = jax.value_and_grad(ref_loss)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    loss, grads = step_mod.value_and_grad(
        port_loss, params_from_reference(tree, device="cpu"),
        torch.from_numpy(x))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-6)
    got, want = by_path(grads), ref_by_path(rgrads)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert not got["unused"].any() and not got["nested/skipped"].any()


def test_remat_gives_the_same_gradients():
    _, cfg = configs("h2o_danube_1_8b")
    ref_cfg = ref_smoke_config(ref_get_config("h2o_danube_1_8b"))
    params = params_from_reference(reference_tree(ref_cfg), device="cpu")
    batch = to_port(lm_batch(cfg.vocab, 2, 100))
    out = {}
    for remat in (False, True):
        out[remat] = step_mod.value_and_grad(
            api.build_model(cfg, port_opts("flash_torch", remat)).loss,
            params, batch)
    assert torch.equal(out[True][0], out[False][0])
    for (p, a), (_, b) in zip(leaf_paths(out[True][1]),
                              leaf_paths(out[False][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9, msg=p)


def test_layers_are_unbound_once_per_call():
    """The stack's gradient is one ``stack`` of the layers' gradients,
    not one zero-filled stack per layer (``select``'s backward)."""
    _, cfg = configs("h2o_danube_1_8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            port_opts())
    wq = params["attn_layers"]["wq"].requires_grad_()
    loss = lm.loss_fn(cfg, params, to_port(lm_batch(cfg.vocab, 1, 16)),
                      port_opts())
    readers, seen, stack = [], set(), [loss.grad_fn]
    while stack:                 # the graph nodes that read wq itself
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        for f, _ in fn.next_functions:
            if getattr(f, "variable", None) is wq:
                readers.append(type(fn).__name__)
            stack.append(f)
    assert readers == ["UnbindBackward0"]
    loss.backward()
    assert wq.grad is not None and bool(wq.grad[1].abs().sum() > 0)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(accum):
    """The whole step against the reference's: loss, grad norm, lr, and
    the new first moment, which after one step is (1 - b1) x the clipped
    (accumulated) gradient."""
    ref_cfg, cfg = configs("qwen2_1_5b")
    tree = reference_tree(ref_cfg, seed=6)
    batch = lm_batch(cfg.vocab, 4, 64, seed=7)
    adamw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    ref_fn = ref_step.make_train_step(
        ref_cfg, ref_opts(), ref_step.TrainConfig(
            adamw=ref_opt.AdamWConfig(**adamw), accum_steps=accum))
    jparams = jax.tree.map(jnp.asarray, tree)
    _, rstate, rmetrics = ref_fn(jparams, ref_opt.init(jparams),
                                 to_ref(batch))
    fn = step_mod.make_train_step(cfg, port_opts(), step_mod.TrainConfig(
        adamw=opt.AdamWConfig(**adamw), accum_steps=accum))
    params = params_from_reference(tree, device="cpu")
    _, state, metrics = fn(params, opt.init(params), to_port(batch))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(rmetrics[key]), rtol=1e-5)
    assert int(state.step) == int(rstate.step) == 1
    assert_leaves_close(state.mu, rstate.mu)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def test_update_on_identical_gradients_matches_the_reference():
    """Two reference updates from a perturbed tree; the port takes the
    second from the converted state after the first, on the same
    gradients (converted, not recomputed)."""
    ref_cfg, _ = configs("h2o_danube_1_8b")
    tree = reference_tree(ref_cfg, seed=8)
    rng = np.random.default_rng(9)
    grads = [jax.tree.map(lambda a: 0.3 * rng.standard_normal(
        a.shape, dtype=np.float32), tree) for _ in range(2)]
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=20, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, tree)
    jp, jstate, _ = ref_opt.update(ref_opt.AdamWConfig(**cfg), jp,
                                   jax.tree.map(jnp.asarray, grads[0]),
                                   ref_opt.init(jp))
    want_p, want_s, want_m = ref_opt.update(
        ref_opt.AdamWConfig(**cfg), jp, jax.tree.map(jnp.asarray, grads[1]),
        jstate)
    params = params_from_reference(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    state = optimizer_state_from_reference(
        jax.tree.map(np.asarray, jstate), device="cpu")
    got_p, got_s, got_m = opt.update(
        opt.AdamWConfig(**cfg), params,
        params_from_reference(grads[1], device="cpu"), state)
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu),
                      (got_s.nu, want_s.nu)):
        got, want = by_path(got), ref_by_path(want)
        assert set(got) == set(want)
        for name, w in want.items():
            # where p and lr x delta nearly cancel, rtol alone would ask
            # for more than the operands' own rounding: 1e-6 x max|leaf|
            np.testing.assert_allclose(
                got[name].numpy(), w, rtol=1e-6,
                atol=1e-6 * float(np.abs(w).max()), err_msg=name)
    assert int(got_s.step) == int(want_s.step) == 2
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=1e-6)


class Ref:
    """The reference's optimizer over jnp arrays."""
    opt = ref_opt
    array = staticmethod(jnp.array)
    value = staticmethod(float)


class Port:
    """The port's optimizer over torch tensors."""
    opt = opt
    array = staticmethod(torch.tensor)
    value = staticmethod(float)


BOTH = pytest.mark.parametrize("pkg", [Ref, Port], ids=["reference", "port"])


@BOTH
def test_adamw_minimizes_quadratic(pkg):
    cfg = pkg.opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                              total_steps=200)
    params = {"w": pkg.array([5.0, -3.0])}
    state = pkg.opt.init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = pkg.opt.update(cfg, params, grads, state)
    assert float(abs(params["w"]).max()) < 0.1


@BOTH
def test_grad_clipping(pkg):
    cfg = pkg.opt.AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": pkg.array([0.0, 0.0, 0.0])}
    state = pkg.opt.init(params)
    _, state, metrics = pkg.opt.update(
        cfg, params, {"w": pkg.array([100.0, 100.0, 100.0])}, state)
    assert float(metrics["grad_norm"]) > 100
    # the first moment holds (1 - b1) x the gradient clipped to norm 1
    np.testing.assert_allclose(np.asarray(state.mu["w"]),
                               [0.1 / math.sqrt(3)] * 3, rtol=1e-5)


@BOTH
def test_lr_schedule_shape(pkg):
    cfg = pkg.opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_frac=0.1)
    lrs = [float(pkg.opt.lr_schedule(cfg, pkg.array(s))) for s in range(100)]
    assert lrs[0] < lrs[9]                      # warmup rising
    assert max(lrs) <= 1.0 + 1e-6
    assert lrs[-1] >= 0.1 * 0.99                # floor respected
    assert lrs[50] > lrs[99]                    # decaying


def test_lr_schedule_and_global_norm_match_the_reference():
    cfg = dict(lr=2e-3, warmup_steps=7, total_steps=50, min_lr_frac=0.05)
    for s in (0, 3, 6, 7, 8, 30, 49, 60):
        np.testing.assert_allclose(
            float(opt.lr_schedule(opt.AdamWConfig(**cfg), torch.tensor(s))),
            float(ref_opt.lr_schedule(ref_opt.AdamWConfig(**cfg),
                                      jnp.array(s))), rtol=1e-6)
    rng = np.random.default_rng(0)
    tree = {"b": {"x": arr(rng, 7, 3)}, "a": arr(rng, 11)}
    np.testing.assert_allclose(
        float(opt.global_norm(params_from_reference(tree, device="cpu"))),
        float(ref_opt.global_norm(tree)), rtol=1e-6)


# --------------------------------------------------------------------------
# fault tolerance: the copied module, over both packages
# --------------------------------------------------------------------------

FT = pytest.mark.parametrize("m", [ref_ft, ft], ids=["reference", "port"])


@FT
def test_straggler_detection(m):
    mon = m.HeartbeatMonitor(4, straggler_factor=1.5)
    for step in range(8):
        for w in range(4):
            mon.heartbeat(w, 1.0 if w != 2 else 2.5, now=float(step))
    assert mon.stragglers() == [2]


@FT
def test_dead_worker_detection_is_pure_query(m):
    mon = m.HeartbeatMonitor(3, dead_after_s=10)
    for w in range(3):
        mon.heartbeat(w, 1.0, now=0.0)
    mon.heartbeat(0, 1.0, now=20.0)
    mon.heartbeat(1, 1.0, now=20.0)
    assert mon.dead(now=25.0) == [2]
    assert mon.dead(now=25.0) == [2]
    assert mon.alive_count() == 3
    assert mon.mark_dead(now=25.0) == [2]
    assert mon.alive_count() == 2
    assert mon.dead(now=25.0) == []
    assert mon.mark_dead([2]) == []


@FT
def test_dead_worker_rejoins_on_heartbeat(m):
    mon = m.HeartbeatMonitor(2, dead_after_s=10)
    mon.heartbeat(0, 1.0, now=0.0)
    mon.heartbeat(1, 9.0, now=0.0)
    mon.mark_dead(now=20.0)
    assert mon.alive_count() == 0
    mon.heartbeat(1, 1.0, now=21.0)
    assert mon.alive_count() == 1
    assert mon.workers[1].step_times == [1.0]


@FT
def test_replan_mesh_boundaries(m):
    with pytest.raises(ValueError):
        m.replan_mesh(0, 4)
    with pytest.raises(ValueError):
        m.replan_mesh(-3, 1)
    assert m.replan_mesh(1, 1) == m.ElasticPlan(data=1, model=1)
    assert m.replan_mesh(3, 8) == m.ElasticPlan(data=1, model=2)
    assert m.replan_mesh(1, 8) == m.ElasticPlan(data=1, model=1)
    assert m.replan_mesh(7, 4) == m.ElasticPlan(data=1, model=4)
    assert m.replan_mesh(8, 4) == m.ElasticPlan(data=2, model=4)
    assert m.replan_mesh(513, 4) == m.ElasticPlan(data=128, model=4)


def test_replan_mesh_agrees_with_the_reference():
    for survivors in range(1, 300, 7):
        for mp in (1, 2, 4, 8, 16):
            assert dataclasses.asdict(ft.replan_mesh(survivors, mp)) \
                == dataclasses.asdict(ref_ft.replan_mesh(survivors, mp))


@FT
def test_run_with_recovery_loses_bounded_steps(m):
    saved = {"step": 0}
    done = []

    def save_fn(s):
        saved["step"] = s

    steps, recoveries = m.run_with_recovery(
        50, done.append, save_fn, lambda: saved["step"], save_every=10,
        failure_at=25)
    assert steps == 50 and recoveries == 1
    assert done.count(19) == 1 and done.count(20) == 2


@FT
def test_run_with_recovery_budget_stops_persistent_failure(m):
    attempts = []

    def step_fn(s):
        if s == 3:
            attempts.append(s)
            raise RuntimeError("bad node")

    with pytest.raises(RuntimeError, match="recovery budget") as ei:
        m.run_with_recovery(10, step_fn, lambda s: None, lambda: 0,
                            save_every=100, max_recoveries=4)
    assert len(attempts) == 5
    assert "bad node" in str(ei.value.__cause__)


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------

def test_fit_checkpoint_restart_reproduces_run():
    """``tests/test_system.py``'s check on the port, on the CPU."""
    cfg = smoke_config(get_config("qwen2_1_5b"))
    with tempfile.TemporaryDirectory() as d:
        full = fit(cfg, loop=LoopConfig(steps=12, seq_len=32,
                                        global_batch=2, save_every=100),
                   verbose=False, device="cpu")
        part = fit(cfg, loop=LoopConfig(steps=6, seq_len=32, global_batch=2,
                                        save_every=6, ckpt_dir=d),
                   verbose=False, device="cpu")
        rest = fit(cfg, loop=LoopConfig(steps=12, seq_len=32,
                                        global_batch=2, save_every=6,
                                        ckpt_dir=d),
                   verbose=False, device="cpu")
    assert part.resumed_from is None and rest.resumed_from == 6
    assert rest.steps_done == 12 and len(rest.losses) == 6
    np.testing.assert_allclose(part.losses, full.losses[:6], rtol=1e-6)
    np.testing.assert_allclose(rest.losses, full.losses[6:], rtol=1e-4,
                               atol=1e-4)
    assert len(full.grad_norms) == 12 and all(
        np.isfinite(full.grad_norms))


def test_fit_starts_at_ln_vocab():
    """Random init gives loss ln V: the reference's own smoke bar."""
    cfg = smoke_config(get_config("h2o_danube_1_8b"))
    r = fit(cfg, opts=L.ModelOptions(dtype=torch.float32, remat=True),
            loop=LoopConfig(steps=2, seq_len=64, global_batch=2),
            verbose=False, device="cpu")
    assert abs(r.losses[0] - math.log(cfg.vocab)) < 1.0


def test_fit_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(get_config("qwen2_1_5b"))
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        fit(cfg, loop=LoopConfig(steps=1, seq_len=8, global_batch=1),
            verbose=False)


# --------------------------------------------------------------------------
# the kernels refuse autograd, as the reference's Pallas path does
# --------------------------------------------------------------------------

def test_kernels_refuse_autograd_on_the_cpu_too():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(arr(rng, 1, 16, 2, 8)) for _ in range(3))
    x, scale = torch.from_numpy(arr(rng, 3, 8)), torch.ones(8)
    with pytest.raises(RuntimeError, match="has no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="has no backward"):
        ops.rmsnorm(x, scale.requires_grad_())
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape
        assert ops.rmsnorm(x, scale).shape == x.shape
    q.requires_grad_(False)
    scale.requires_grad_(False)
    assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.rmsnorm(x, scale).grad_fn is None


def test_reference_pallas_path_refuses_grad_too():
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(arr(rng, 1, 16, 2, 8)) for _ in range(3))
    from repro.kernels import ops as ref_ops
    with pytest.raises(Exception):
        jax.grad(lambda q: ref_ops.flash_attention(q, k, v).sum())(q)


def test_a_train_step_through_the_kernel_path_raises():
    _, cfg = configs("h2o_danube_1_8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            port_opts())
    fn = step_mod.make_train_step(cfg, L.ModelOptions(
        dtype=torch.float32, attn_impl="cuda", remat=False))
    with pytest.raises(RuntimeError, match="has no backward"):
        fn(params, opt.init(params), to_port(lm_batch(cfg.vocab, 1, 16)))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_measured_provider_predicts_real_step_time_on_the_card():
    """The port's ``test_measured_provider_predicts_real_step_time``:
    ``fit`` of full-width h2o_danube_1_8b (bf16, no remat, B=2 x S=4096)
    against the 1M1P1D prediction of ``TorchMeasuredProvider``, at the
    reference's factor-3 bar. Needs a CUDA device (about a minute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check times the card")
    from repro_torch.core import (H100_CLUSTER, DistSim, Strategy,
                                  TorchMeasuredProvider)
    cfg = get_config("h2o_danube_1_8b")
    r = fit(cfg, opts=L.ModelOptions(dtype=torch.bfloat16, remat=False),
            loop=LoopConfig(steps=6, seq_len=4096, global_batch=2),
            verbose=False)
    measured = float(np.median(r.step_times[2:]))
    provider = TorchMeasuredProvider(H100_CLUSTER, dtype=torch.bfloat16,
                                     tf32=False)
    predicted = DistSim(cfg, Strategy(), global_batch=2, seq=4096,
                        provider=provider).simulate().batch_time
    assert predicted > 0 and all(np.isfinite(r.losses))
    assert 1 / 3 < predicted / measured < 3.0, \
        f"predicted {predicted:.4f}s vs measured {measured:.4f}s"


@pytest.mark.gpu
def test_score_products_on_the_tensor_cores_are_fp32_sums():
    """On the card ``flash_torch``'s bf16 q·kᵀ runs on the tensor cores
    with an fp32 output. Products of bf16 values are exact in fp32, so it
    equals the fp32 GEMM of the same values (TF32 off) up to the order of
    the fp32 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    a, b = (torch.randn((2, 4, n, 80), generator=g, device="cuda")
            .to(torch.bfloat16) for n in (300, 700))
    got = L._dots(a, b)
    want = L._dots(a.float(), b.float())
    assert got.dtype == torch.float32 and got.shape == (2, 4, 300, 700)
    top = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * top)


@pytest.mark.gpu
def test_a_train_step_through_the_kernel_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = smoke_config(get_config("h2o_danube_1_8b"))
    dev = torch.device("cuda")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev,
                            port_opts())
    fn = step_mod.make_train_step(cfg, L.ModelOptions(
        dtype=torch.float32, attn_impl="cuda", remat=False))
    batch = {k: v.to(dev) for k, v in to_port(lm_batch(cfg.vocab, 1, 16))
             .items()}
    with pytest.raises(RuntimeError, match="has no backward"):
        fn(params, opt.init(params), batch)
