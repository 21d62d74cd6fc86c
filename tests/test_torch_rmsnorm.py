"""The port's RMSNorm (kernel module K3 and its ``ops`` wrapper) against
the reference's: the same inputs, made from a seed with numpy, go
through ``repro.kernels.ops.rmsnorm`` (Pallas in interpret mode on the
CPU) and ``repro_torch.kernels.ops.rmsnorm`` (its plain PyTorch version
on CPU tensors), on the shapes of ``tests/test_kernels.py`` plus the
model's width 2560. Bars: 1e-5 in fp32, 2e-2 in bf16 (the reference
rounds where XLA rounds). The kernel's plan (which variant, how many
vectors a thread and threads a row) is pure Python and is checked here
for every d_model of the configs; the kernel itself, on the card, is
held to its plain version within one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.configs.base import get_config, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers
from repro_torch.telemetry import COUNTS

SHAPES = [(8, 128), (3, 100, 96), (2, 5, 7, 256), (1, 512), (4, 2560)]
DTYPES = [("float32", torch.float32, 1e-5), ("bfloat16", torch.bfloat16,
                                              2e-2)]


#: every distinct d_model of the configs
WIDTHS = sorted({get_config(a).d_model for a in list_archs()})
SCALE_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


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
    before = COUNTS.get("k3.launches", 0)
    rn.rmsnorm(x, sc)
    assert COUNTS.get("k3.launches", 0) == before
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_cuda(x, sc)
    with pytest.raises(ValueError, match="block_rows"):
        rn.rmsnorm(x, sc, block_rows=0)


def test_config_widths_are_the_published_ones():
    assert set(WIDTHS) >= {384, 1024, 1536, 2048, 2560, 4096, 5120, 6144,
                           8192, 12288}


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", SCALE_DTYPES)
def test_every_config_width_plans_the_register_variant(d, x_dtype,
                                                       scale_dtype):
    p = rn.plan(d, x_dtype, scale_dtype)
    assert p.variant == "rows"
    assert p.vec == 16 // x_dtype.itemsize
    # every lane equally loaded: no remainder round, no idle thread
    assert p.vpt * p.vec * p.threads_per_row == d
    assert 1 <= p.vpt <= rn.VPT_MAX
    tpr = p.threads_per_row
    assert tpr & (tpr - 1) == 0 and tpr <= rn.BLOCK_THREADS
    assert p.rows_per_block * tpr == rn.BLOCK_THREADS


def test_plan_examples():
    # the main shape: one warp a row, ten vectors a thread
    assert rn.plan(2560, torch.bfloat16, torch.bfloat16) == rn.Plan(
        "rows", 8, 10, 32, 8)
    # part of a warp a row, and several warps a row
    assert rn.plan(384, torch.bfloat16, torch.float32) == rn.Plan(
        "rows", 8, 3, 16, 16)
    assert rn.plan(12288, torch.bfloat16, torch.bfloat16) == rn.Plan(
        "rows", 8, 12, 128, 2)
    assert rn.plan(12288, torch.float32, torch.float32) == rn.Plan(
        "rows", 4, 12, 256, 1)
    assert rn.plan(8, torch.bfloat16, torch.bfloat16) == rn.Plan(
        "rows", 8, 1, 1, 256)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_plan_takes_the_general_variant_outside_the_register_plan(x_dtype):
    vec = 16 // x_dtype.itemsize
    general = [
        rn.plan(2561, x_dtype, torch.float32),            # d % vec != 0
        rn.plan(vec + 1, x_dtype, torch.bfloat16),
        rn.plan(2560, x_dtype, torch.bfloat16, aligned=False),
        # wider than 256 threads x 16 vectors
        rn.plan(2 * rn.BLOCK_THREADS * rn.VPT_MAX * vec, x_dtype,
                torch.float32),
        # 17 vectors: no power-of-two thread count divides them evenly
        rn.plan(17 * vec, x_dtype, torch.float16),
    ]
    for p in general:
        assert p.variant == "general" and p.vpt == 0
        assert p.threads_per_row % 32 == 0
        assert 32 <= p.threads_per_row <= rn.BLOCK_THREADS
        assert p.rows_per_block == 1
    # the widest register row: 256 threads x 16 vectors
    widest = rn.BLOCK_THREADS * rn.VPT_MAX * vec
    assert rn.plan(widest, x_dtype, torch.float32).variant == "rows"


def test_plan_edges():
    for dt in (torch.float32, torch.bfloat16):
        p = rn.plan(1, dt, torch.float32)
        assert p == rn.Plan("general", 16 // dt.itemsize, 0, 32, 1)
    with pytest.raises(ValueError, match="width"):
        rn.plan(0, torch.float32, torch.float32)
    with pytest.raises(TypeError, match="x in"):
        rn.plan(64, torch.float16, torch.float32)
    with pytest.raises(TypeError, match="scale in"):
        rn.plan(64, torch.float32, torch.float64)


@pytest.mark.parametrize("shape", [(0, 64), (2, 0, 64), (5, 1), (0, 1)])
def test_no_rows_and_width_one(shape):
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal(shape, dtype=np.float32))
    sc = torch.full(shape[-1:], 0.5)
    got = ops.rmsnorm(x, sc)
    assert got.shape == x.shape and got.dtype == x.dtype
    xf = x.numpy().astype(np.float64)
    want = xf / np.sqrt((xf ** 2).mean(-1, keepdims=True) + 1e-6) * 0.5 \
        if x.numel() else xf
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def bf16_ulps(a, b):
    """The largest distance between two bf16 tensors in ulps, on their
    uint16 patterns (sign-magnitude mapped to a line)."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(a) - line(b)).abs().max()) if a.numel() else 0


def test_bf16_ulps_counts_on_the_bit_patterns():
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    nxt = torch.tensor([1.0078125], dtype=torch.bfloat16)   # 1 + 2^-7
    assert bf16_ulps(one, one) == 0 and bf16_ulps(one, nxt) == 1
    zero = torch.tensor([0.0, -0.0], dtype=torch.bfloat16)
    assert bf16_ulps(zero, zero.flip(0)) == 0
    tiny = torch.tensor([2.0 ** -133], dtype=torch.bfloat16)  # denormal
    assert bf16_ulps(tiny, -tiny) == 2


def card_cases():
    """(name, rows, d, x dtype) that reach every variant ``plan``
    returns: the register variant at each count of vectors a thread,
    1..16 (one warp a row), part of a warp and several warps a row, and
    the general variant for d % vec != 0, an odd vector count, an
    unaligned view and an over-wide row."""
    out = []
    for dt in (torch.float32, torch.bfloat16):
        vec = 16 // dt.itemsize
        for vpt in range(1, rn.VPT_MAX + 1):
            out.append((f"vpt{vpt}", 37, vpt * 32 * vec, dt))
        out += [("sub-warp", 53, 384 if dt == torch.bfloat16 else 8, dt),
                ("warps", 19, 5120, dt), ("warps", 11, 12288, dt),
                ("8 warps", 5, 256 * 12 * vec, dt),
                ("d % vec", 7, 2561, dt), ("odd vectors", 9, 17 * vec, dt),
                ("unaligned", 37, 2560, dt),
                ("over-wide", 3, 2 * rn.BLOCK_THREADS * rn.VPT_MAX * vec,
                 dt)]
    return out


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA device and nvcc: the kernel against its plain
    version in every variant ``plan`` can return, fp32 and bf16, every
    scale dtype, eps 1e-3 and an unaligned view besides the reference's
    shapes. Bars: one bf16 ulp (both round an fp32 result once; only the
    sum's order differs), 1e-5 in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    reached = set()
    cases = [(str(s), s[:-1], s[-1], dt) for s in SHAPES + [(5, 3)]
             for _, dt, _ in DTYPES] + [
        (name, (rows,), d, dt) for name, rows, d, dt in card_cases()]
    for name, lead, d, dt in cases:
        n = int(np.prod(lead))
        rng = np.random.default_rng(d + n)
        buf = torch.from_numpy(rng.standard_normal(n * d + 1,
                                                   dtype=np.float32))
        buf = buf.to("cuda", dt)
        unaligned = name == "unaligned"
        xt = (buf[1:] if unaligned else buf[:-1]).view(*lead, d)
        assert (xt.data_ptr() % 16 != 0) == unaligned
        for sdt in SCALE_DTYPES:
            st = torch.from_numpy(rng.standard_normal(d, dtype=np.float32))
            st = st.to("cuda", sdt)
            for eps in (1e-6, 1e-3):
                p = rn.plan(d, dt, sdt, xt.data_ptr() % 16 == 0)
                reached.add((p.variant, p.vpt, dt))
                before = COUNTS.get("k3.launches", 0)
                got = ops.rmsnorm(xt, st, eps=eps)
                torch.cuda.synchronize()
                assert COUNTS.get("k3.launches", 0) == before + 1
                want = rn.rmsnorm_plain(xt, st, eps)
                what = f"{name} d={d} {dt} scale {sdt} eps {eps}"
                if dt == torch.bfloat16:
                    assert bf16_ulps(got, want) <= 1, what
                else:
                    torch.testing.assert_close(got, want, atol=1e-5,
                                               rtol=1e-5, msg=what)
    for dt in (torch.float32, torch.bfloat16):
        assert {("rows", v, dt) for v in range(1, rn.VPT_MAX + 1)} \
            | {("general", 0, dt)} <= reached
