"""The port's MoE FFN (``repro_torch.models.moe``) against the
reference's ``repro.models.moe``: the cases of ``tests/test_moe.py``
(all but the expert-parallel all-to-all, which needs a process group)
over the port, and the port held against the live reference on the same
seeded numpy inputs — outputs and the aux loss in fp32 at 1e-5 (1e-4
where the reference's own gather/dense bar is 1e-4), gradients against
``jax.grad`` at 2e-5 × max|g|. Three framework differences are pinned:
the per-expert queue is a stable sort (equal gates at the capacity
boundary keep the lower token), top-k ties go to the lower expert, and
the combine adds in the output dtype in one fixed order.
"""
import dataclasses

import numpy as np
import pytest

hp = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import moe as R
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as M


def setup(seed, t, d, e, f, top_k, cf=1.25):
    """Seeded numpy inputs and the two packages' configs."""
    rng = np.random.default_rng(seed)
    arrays = {
        "router": rng.standard_normal((d, e), dtype=np.float32) * 0.1,
        "w_gate": rng.standard_normal((e, d, f), dtype=np.float32) * 0.1,
        "w_up": rng.standard_normal((e, d, f), dtype=np.float32) * 0.1,
        "w_down": rng.standard_normal((e, f, d), dtype=np.float32) * 0.1,
    }
    x = rng.standard_normal((2, t // 2, d), dtype=np.float32)
    kw = dict(n_experts=e, top_k=top_k, d_ff_expert=f, capacity_factor=cf)
    return x, arrays, MoEConfig(**kw), RefMoEConfig(**kw)


def port(x, arrays, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype),
            {k: torch.from_numpy(v).to(dtype) for k, v in arrays.items()})


def ref(x, arrays, dtype=jnp.float32):
    return (jnp.asarray(x).astype(dtype),
            {k: jnp.asarray(v).astype(dtype) for k, v in arrays.items()})


@pytest.mark.parametrize("impl", ["gather", "dense_dispatch"])
@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (1, 1.0), (2, 0.5)])
def test_outputs_and_aux_match_the_reference(impl, top_k, cf):
    x, arrays, mcfg, rcfg = setup(0, 64, 16, 8, 32, top_k, cf)
    y, aux = M.moe_ffn(*port(x, arrays), mcfg, impl)
    ry, raux = R.moe_ffn(*ref(x, arrays), rcfg, impl)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_gather_matches_dense_dispatch():
    x, arrays, mcfg, _ = setup(0, 64, 16, 8, 32, 2)
    yg, _ = M.moe_gather(*port(x, arrays), mcfg)
    yd, _ = M.moe_dense_dispatch(*port(x, arrays), mcfg)
    np.testing.assert_allclose(yg.numpy(), yd.numpy(), atol=1e-4, rtol=1e-4)


@hp.given(e=st.sampled_from([4, 8]), top_k=st.sampled_from([1, 2]),
          seed=st.integers(0, 4))
@hp.settings(max_examples=10, deadline=None)
def test_gather_dense_equivalence_property(e, top_k, seed):
    x, arrays, mcfg, rcfg = setup(seed, 32, 8, e, 16, top_k)
    yg, _ = M.moe_gather(*port(x, arrays), mcfg)
    yd, _ = M.moe_dense_dispatch(*port(x, arrays), mcfg)
    np.testing.assert_allclose(yg.numpy(), yd.numpy(), atol=1e-4, rtol=1e-4)
    ry, _ = R.moe_gather(*ref(x, arrays), rcfg)
    np.testing.assert_allclose(yg.numpy(), np.asarray(ry), atol=1e-5,
                               rtol=1e-5)


def test_router_weights_normalized():
    x, arrays, mcfg, rcfg = setup(1, 32, 8, 4, 16, 2)
    probs, topi, topw = M.router_probs(torch.from_numpy(x).reshape(-1, 8),
                                       torch.from_numpy(arrays["router"]),
                                       mcfg)
    np.testing.assert_allclose(topw.sum(-1).numpy(), 1.0, atol=1e-6)
    assert bool((probs >= 0).all())
    rp, ri, rw = R.router_probs(jnp.asarray(x).reshape(-1, 8),
                                jnp.asarray(arrays["router"]), rcfg)
    assert topi.tolist() == np.asarray(ri).tolist()
    np.testing.assert_allclose(topw.numpy(), np.asarray(rw), rtol=1e-6)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: ``lax.top_k`` picks the lower expert
    indices, and so does the port."""
    mcfg = MoEConfig(n_experts=8, top_k=3, d_ff_expert=4)
    rcfg = RefMoEConfig(n_experts=8, top_k=3, d_ff_expert=4)
    x = np.ones((5, 4), np.float32)
    w = np.zeros((4, 8), np.float32)
    w[:, 5] = w[:, 6] = 0.5                    # two experts tie on top
    _, topi, _ = M.router_probs(torch.from_numpy(x), torch.from_numpy(w),
                                mcfg)
    _, ri, _ = R.router_probs(jnp.asarray(x), jnp.asarray(w), rcfg)
    assert topi.tolist() == np.asarray(ri).tolist()
    assert topi[0].tolist() == [5, 6, 0]


def test_capacity_ties_keep_the_lower_token():
    """Every token routes to the same expert with the same gate: the
    expert's queue keeps the first ``capacity`` tokens, as the
    reference's stable ``argsort`` does. An unstable sort would keep an
    arbitrary set."""
    t, d = 64, 8
    mcfg = MoEConfig(n_experts=4, top_k=1, d_ff_expert=8,
                     capacity_factor=1.0)
    rcfg = RefMoEConfig(n_experts=4, top_k=1, d_ff_expert=8,
                        capacity_factor=1.0)
    rng = np.random.default_rng(3)
    arrays = {"router": np.zeros((d, 4), np.float32),
              "w_gate": rng.standard_normal((4, d, 8), dtype=np.float32),
              "w_up": rng.standard_normal((4, d, 8), dtype=np.float32),
              "w_down": rng.standard_normal((4, 8, d), dtype=np.float32)}
    arrays["router"][:, 2] = 50.0              # expert 2 wins everywhere
    x = np.abs(rng.standard_normal((1, t, d), dtype=np.float32)) + 1.0
    x = np.broadcast_to(x[:, :1], x.shape).copy()   # equal gates
    cap = M.capacity(t, mcfg)
    assert cap < t
    y, _ = M.moe_gather(*port(x, arrays), mcfg)
    ry, _ = R.moe_gather(*ref(x, arrays), rcfg)
    kept = (y[0].abs().sum(-1) > 0).tolist()
    assert kept == [True] * cap + [False] * (t - cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-5,
                               rtol=1e-5)


def test_bf16_combine_adds_as_the_references_scatter():
    """The combine alone, on the same bf16 expert rows: eight bf16 adds a
    token (top-8 of 16 experts) in ascending expert order give the bits
    of the reference's ``.at[].add`` in bf16 on the CPU."""
    x, arrays, mcfg, rcfg = setup(5, 64, 32, 16, 32, 8, cf=2.0)
    t, e = 64, 16
    x2d = torch.from_numpy(x).reshape(t, -1)
    cap = M.capacity(t, mcfg)
    _, topi, sel, order = M._routing(x2d, torch.from_numpy(arrays["router"]),
                                     mcfg, cap)
    chosen = order[:cap].T
    live = torch.isfinite(torch.gather(sel, 0, chosen.T).T)
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.standard_normal((e, cap, 32), dtype=np.float32)
                         ).to(torch.bfloat16) * live[..., None]
    got = M.combine(y, order, topi)
    yj = jnp.asarray(y.float().numpy()).astype(jnp.bfloat16)
    want = jnp.zeros((t, 32), jnp.bfloat16).at[
        jnp.asarray(chosen.reshape(-1).numpy())].add(yj.reshape(e * cap, 32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_capacity_bounds():
    mcfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16)
    assert M.capacity(4, mcfg) == 4
    c = M.capacity(1024, mcfg)
    assert c % 8 == 0 and c >= 1024 * 2 // 8
    assert c == R.capacity(1024, RefMoEConfig(n_experts=8, top_k=2,
                                              d_ff_expert=16))


def test_dropless_capacity_factor_exact_for_any_expert_count():
    for e in (3, 4, 7, 16, 17, 64):
        for k in (1, 2, 3, 5, 7):
            if k > e:
                continue
            mcfg = MoEConfig(n_experts=e, top_k=k, d_ff_expert=8)
            mcfg = dataclasses.replace(
                mcfg, capacity_factor=M.dropless_capacity_factor(mcfg))
            assert M.dropless_capacity_factor(mcfg) == \
                R.dropless_capacity_factor(mcfg)
            for t in (1, 2, 7, 32, 49, 333, 4096):
                assert M.capacity(t, mcfg) == t, (e, k, t)


@pytest.mark.parametrize("impl", ["gather", "dense_dispatch"])
def test_gradients_through_the_gates_match_jax_grad(impl):
    x, arrays, mcfg, rcfg = setup(2, 32, 8, 4, 16, 2)

    def ref_loss(p, xx):
        y, aux = R.moe_ffn(xx, p, rcfg, impl)
        return (y ** 2).sum() + 0.01 * aux

    rx, rp = ref(x, arrays)
    want, want_x = jax.grad(ref_loss, argnums=(0, 1))(rp, rx)
    px, pp = port(x, arrays)
    px.requires_grad_(True)
    for v in pp.values():
        v.requires_grad_(True)
    y, aux = M.moe_ffn(px, pp, mcfg, impl)
    ((y ** 2).sum() + 0.01 * aux).backward()
    assert float(pp["router"].grad.abs().sum()) > 0
    assert float(pp["w_gate"].grad.abs().sum()) > 0
    for name, w in list(want.items()) + [("x", want_x)]:
        g = (px if name == "x" else pp[name]).grad.numpy()
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), name


def test_aux_loss_prefers_balance():
    x, arrays, mcfg, _ = setup(3, 64, 8, 4, 16, 1)
    arrays["router"] = np.zeros_like(arrays["router"])        # uniform
    _, aux_uniform = M.moe_ffn(*port(x, arrays), mcfg)
    arrays["router"][:, 0] = 10.0                             # collapsed
    _, aux_collapsed = M.moe_ffn(*port(x, arrays), mcfg)
    assert float(aux_uniform) < float(aux_collapsed)
    np.testing.assert_allclose(float(aux_uniform), 1.0, rtol=1e-6)


def test_the_combine_is_the_same_on_every_run():
    """No atomics: the same inputs give the same bits run after run."""
    x, arrays, mcfg, _ = setup(4, 64, 16, 8, 32, 2)
    a, _ = M.moe_gather(*port(x, arrays, torch.bfloat16), mcfg)
    b, _ = M.moe_gather(*port(x, arrays, torch.bfloat16), mcfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
