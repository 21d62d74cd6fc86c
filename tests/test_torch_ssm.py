"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm``: the cases of ``tests/test_ssm.py``
(the chunked scan against a float64 recurrence oracle, chunk-size
invariance, ``_segsum``, decay stability) over the port, then
``ssd_chunked``, ``_causal_conv``, ``ssm_block`` and
``ssm_block_decode`` against the live reference on the same seeded numpy
inputs at 1e-5 in fp32 (scans summed in another order).
"""
import numpy as np
import pytest

hp = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs.base import SSMConfig as RefSSMConfig
from repro.models import ssm as R
from repro_torch.configs.base import SSMConfig
from repro_torch.models import ssm as S

TOL = dict(atol=1e-5, rtol=1e-5)


def ssd_naive(x, dt, A, B_mat, C_mat):
    """O(L) sequential recurrence oracle: h ← h·exp(dtA) + dt·x⊗B."""
    b, l, h, p = x.shape
    n = B_mat.shape[-1]
    hstate = np.zeros((b, h, p, n), np.float64)
    ys = np.zeros((b, l, h, p), np.float64)
    xd = np.asarray(x, np.float64) * np.asarray(dt, np.float64)[..., None]
    dA = np.asarray(dt, np.float64) * np.asarray(A, np.float64)
    for t in range(l):
        decay = np.exp(dA[:, t])
        hstate = (hstate * decay[..., None, None]
                  + xd[:, t][..., None]
                  * np.asarray(B_mat, np.float64)[:, t, None, None, :])
        ys[:, t] = np.einsum("bhpn,bn->bhp", hstate,
                             np.asarray(C_mat, np.float64)[:, t])
    return ys, hstate


def inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    return x, dt, A, B, C


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_ssd_chunked_matches_recurrence():
    x, dt, A, B, C = inputs(0, 2, 64, 3, 8, 16)
    y, hfin = S.ssd_chunked(*t(x, dt, A, B, C), chunk=16)
    yref, href = ssd_naive(x, dt, A, B, C)
    np.testing.assert_allclose(y.numpy(), yref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(hfin.numpy(), href, atol=1e-3, rtol=1e-3)


@hp.given(l=st.sampled_from([8, 24, 32, 56]),
          chunk=st.sampled_from([8, 16, 32]),
          seed=st.integers(0, 3))
@hp.settings(max_examples=12, deadline=None)
def test_ssd_chunk_size_invariance(l, chunk, seed):
    x, dt, A, B, C = inputs(seed, 1, l, 2, 4, 8)
    y1, h1 = S.ssd_chunked(*t(x, dt, A, B, C), chunk=chunk)
    y2, h2 = S.ssd_chunked(*t(x, dt, A, B, C), chunk=l)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-4, rtol=2e-4)


def test_segsum_semantics():
    s = S._segsum(torch.tensor([1.0, 2.0, 3.0]))
    assert float(s[0, 0]) == 0.0
    assert float(s[1, 0]) == 2.0
    assert float(s[2, 0]) == 5.0
    assert s[0, 1] == -torch.inf
    x = np.random.default_rng(1).standard_normal((2, 3, 7)).astype(
        np.float32)
    np.testing.assert_allclose(S._segsum(torch.from_numpy(x)).numpy(),
                               np.asarray(R._segsum(jnp.asarray(x))), **TOL)


def test_ssd_state_decay_stability():
    x, dt, A, B, C = inputs(2, 1, 512, 2, 4, 8)
    A = np.full_like(A, -2.0)
    y, _ = S.ssd_chunked(*t(x, dt, A, B, C), chunk=64)
    assert bool(torch.isfinite(y).all())
    assert float(y.abs().max()) < 1e3


@pytest.mark.parametrize("l,chunk", [(64, 16), (50, 16), (40, 64)])
def test_ssd_chunked_matches_the_reference(l, chunk):
    """Whole chunks, a ragged tail, and one chunk longer than L."""
    x, dt, A, B, C = inputs(3, 2, l, 3, 8, 16)
    y, h = S.ssd_chunked(*t(x, dt, A, B, C), chunk=chunk)
    ry, rh = R.ssd_chunked(*j(x, dt, A, B, C), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


@pytest.mark.parametrize("k", [2, 4])
def test_causal_conv_matches_the_reference(k):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, 12), dtype=np.float32)
    w = rng.standard_normal((k, 12), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    got = S._causal_conv(*t(x, w, b))
    want = R._causal_conv(*j(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # causal: the first output sees only the first input
    np.testing.assert_allclose(got[:, 0].numpy(),
                               x[:, 0] * w[-1] + b, **TOL)


def block_params(seed, d, scfg):
    rng = np.random.default_rng(seed)
    shapes = S.ssm_params_shape(d, scfg)
    out = {name: (rng.standard_normal(shape, dtype=np.float32) * 0.2)
           for name, shape in shapes.items()}
    out["norm_scale"] += 1.0
    out["D"] += 1.0
    return out


SCFG = dict(d_state=16, head_dim=8, chunk=8, d_conv=4, expand=2)


def test_ssm_block_matches_the_reference():
    d = 32
    params = block_params(5, d, SSMConfig(**SCFG))
    x = np.random.default_rng(6).standard_normal((2, 21, d),
                                                 dtype=np.float32)
    got = S.ssm_block(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in params.items()},
                      SSMConfig(**SCFG))
    want = R.ssm_block(jnp.asarray(x),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       RefSSMConfig(**SCFG))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_block_decode_matches_the_reference_and_the_block():
    """Step by step from an empty cache: each step equals the
    reference's step (output and cache) and the full block's output at
    that position."""
    d, l = 32, 10
    scfg, rcfg = SSMConfig(**SCFG), RefSSMConfig(**SCFG)
    params = block_params(7, d, scfg)
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    x = np.random.default_rng(8).standard_normal((2, l, d), dtype=np.float32)
    full = S.ssm_block(torch.from_numpy(x), pp, scfg)
    cache = S.init_ssm_cache(2, d, scfg, torch.float32)
    rcache = R.init_ssm_cache(2, d, rcfg, jnp.float32)
    for i in range(l):
        y, cache = S.ssm_block_decode(torch.from_numpy(x[:, i:i + 1]), pp,
                                      scfg, cache)
        ry, rcache = R.ssm_block_decode(jnp.asarray(x[:, i:i + 1]), rp, rcfg,
                                        rcache)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
        np.testing.assert_allclose(cache.conv.numpy(),
                                   np.asarray(rcache.conv), **TOL)
        np.testing.assert_allclose(cache.state.numpy(),
                                   np.asarray(rcache.state), **TOL)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, i].numpy(),
                                   atol=2e-4, rtol=2e-4)


def test_dims_shapes_and_cache_are_the_references():
    for d in (64, 2560):
        for scfg in (SSMConfig(**SCFG), SSMConfig()):
            rcfg = RefSSMConfig(**{f: getattr(scfg, f) for f in SCFG})
            assert S.ssm_dims(d, scfg) == R.ssm_dims(d, rcfg)
            assert S.ssm_params_shape(d, scfg) == R.ssm_params_shape(d, rcfg)
    c = S.init_ssm_cache(3, 64, SSMConfig(**SCFG))
    rc = R.init_ssm_cache(3, 64, RefSSMConfig(**SCFG))
    assert tuple(c.conv.shape) == rc.conv.shape
    assert tuple(c.state.shape) == rc.state.shape
    assert c.conv.dtype == torch.bfloat16 and c.state.dtype == torch.float32
