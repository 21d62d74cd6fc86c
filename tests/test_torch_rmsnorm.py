"""The port's RMSNorm (kernel module K3 and its ``ops`` wrapper) against
the reference's: the same inputs, made from a seed with numpy, go
through ``repro.kernels.ops.rmsnorm`` (Pallas in interpret mode on the
CPU) and ``repro_torch.kernels.ops.rmsnorm`` (its plain PyTorch version
on CPU tensors), on the shapes of ``tests/test_kernels.py`` plus the
model's width 2560. Bars: 1e-5 in fp32, 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers

SHAPES = [(8, 128), (3, 100, 96), (2, 5, 7, 256), (1, 512), (4, 2560)]
DTYPES = [("float32", torch.float32, 1e-5), ("bfloat16", torch.bfloat16,
                                              2e-2)]


def inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape[-1:], dtype=np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,dtype,atol", DTYPES)
def test_rmsnorm_shapes_dtypes(shape, name, dtype, atol):
    x, sc = inputs(shape)
    r = ref_ops.rmsnorm(jnp.asarray(x).astype(name), jnp.asarray(sc))
    xt = torch.from_numpy(x).to(dtype)
    st = torch.from_numpy(sc)
    p = ops.rmsnorm(xt, st)
    assert p.dtype == dtype and p.shape == xt.shape
    np.testing.assert_allclose(p.float().numpy(),
                               np.asarray(r.astype(jnp.float32)),
                               atol=atol, rtol=atol)
    np.testing.assert_allclose(p.float().numpy(),
                               ref.rmsnorm_ref(xt, st).float().numpy(),
                               atol=atol, rtol=atol)
    # the model's own norm computes the same function
    np.testing.assert_array_equal(p.float().numpy(),
                                  layers.rmsnorm(xt, st).float().numpy())


def test_scale_of_another_dtype_and_eps():
    x, sc = inputs((6, 64), seed=1)
    r = ref_ops.rmsnorm(jnp.asarray(x), jnp.asarray(sc).astype("bfloat16"),
                        eps=1e-3)
    p = ops.rmsnorm(torch.from_numpy(x),
                    torch.from_numpy(sc).to(torch.bfloat16), eps=1e-3)
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5,
                               rtol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    x, sc = (torch.from_numpy(a) for a in inputs((4, 32)))
    before = rn.LAUNCHES
    rn.rmsnorm(x, sc)
    assert rn.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_cuda(x, sc)
    with pytest.raises(ValueError, match="block_rows"):
        rn.rmsnorm(x, sc, block_rows=0)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA device and nvcc: the kernel against its plain
    version, vector and scalar paths, fp32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for shape in SHAPES + [(5, 3), (7, 2561)]:
        x, sc = inputs(shape)
        for _, dtype, atol in DTYPES:
            xt = torch.from_numpy(x).to("cuda", dtype)
            st = torch.from_numpy(sc).cuda()
            before = rn.LAUNCHES
            got = ops.rmsnorm(xt, st)
            torch.cuda.synchronize()
            assert rn.LAUNCHES == before + 1
            want = rn.rmsnorm_plain(xt, st)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=atol, rtol=atol)
