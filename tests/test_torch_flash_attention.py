"""The port's flash attention (kernel module K2 and its ``ops`` wrapper)
against the reference's: the same inputs, made from a seed with numpy,
go through ``repro.kernels.ops.flash_attention`` (Pallas in interpret
mode on the CPU) and ``repro_torch.kernels.ops.flash_attention`` (its
plain PyTorch version on CPU tensors), on every parametrised case of
``tests/test_kernels.py`` plus the model's head_dim 80 with n_rep 4.

Bars are the reference's own: 2e-5 in fp32, 2e-2 in bf16. The kernel
itself is held against the plain version on the card by the ``gpu``
case below and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
          (1, 200, 8, 2, 32),           # ragged seq (padding path)
          (2, 64, 2, 1, 128),
          (1, 160, 8, 2, 80)]           # the model's hd 80, n_rep 4

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def qkv(b, s, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), dtype=np.float32),
            rng.standard_normal((b, s, kh, hd), dtype=np.float32),
            rng.standard_normal((b, s, kh, hd), dtype=np.float32))


def both(arrays, dtype, causal, window, block_q=128, block_kv=128):
    """(reference output, port output) as fp32 numpy arrays."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    ro = ref_ops.flash_attention(*jx, causal=causal, window=window,
                                 block_q=block_q, block_kv=block_kv)
    tt = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    po = ops.flash_attention(*tt, causal=causal, window=window,
                             block_q=block_q, block_kv=block_kv)
    assert po.dtype == TORCH[dtype] and po.shape == tt[0].shape
    return np.asarray(ro.astype(jnp.float32)), po.float().numpy()


def oracle(arrays, causal, window):
    """The port's full-softmax ``ref.attention_ref`` on (B,S,H,hd)."""
    q, k, v = (torch.from_numpy(a) for a in arrays)
    b, s, h, hd = q.shape
    n_rep = h // k.shape[2]
    k, v = k.repeat_interleave(n_rep, 2), v.repeat_interleave(n_rep, 2)

    def bh(t):
        return t.transpose(1, 2).reshape(b * h, s, hd)

    o = ref.attention_ref(bh(q), bh(k), bh(v), causal, window)
    return o.reshape(b, h, s, hd).transpose(1, 2).numpy()


@pytest.mark.parametrize("b,s,h,kh,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_shapes(b, s, h, kh, hd, causal):
    arrays = qkv(b, s, h, kh, hd)
    r, p = both(arrays, "float32", causal, None, block_q=64, block_kv=96)
    np.testing.assert_allclose(p, r, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(p, oracle(arrays, causal, None), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("window", [16, 64, 1000])
def test_flash_attention_sliding_window(window):
    arrays = qkv(1, 160, 4, 2, 32, seed=1)
    r, p = both(arrays, "float32", True, window, block_q=64, block_kv=64)
    np.testing.assert_allclose(p, r, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(p, oracle(arrays, True, window), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_flash_attention_dtypes(dtype, atol):
    arrays = qkv(2, 128, 4, 2, 64, seed=2)
    r, p = both(arrays, dtype, True, None)
    np.testing.assert_allclose(p, r, atol=atol, rtol=atol)


def test_non_causal_window_and_model_head():
    """The model's own head (hd 80, n_rep 4) with a window but no causal
    mask: the band then reaches forward to the end of the sequence."""
    arrays = qkv(1, 150, 8, 2, 80, seed=3)
    r, p = both(arrays, "float32", False, 40, block_q=64, block_kv=32)
    np.testing.assert_allclose(p, r, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(p, oracle(arrays, False, 40), atol=2e-5,
                               rtol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 32, 2, 1, 32))
    before = fa.LAUNCHES
    fa.flash_attention(q, k, v)
    assert fa.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 32, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_plain(q, k[:, :, :1].expand(1, 32, 3, 32),
                                 v[:, :, :1].expand(1, 32, 3, 32))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)


@pytest.mark.parametrize("fn", [fa.flash_attention, fa.flash_attention_cuda,
                                ops.flash_attention])
def test_query_and_key_lengths_must_match(fn):
    """Positions are the row indices of one sequence: a shorter or
    longer k/v is refused before any implementation runs."""
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 32, 4, 2, 32))
    with pytest.raises(ValueError, match="sequence length"):
        fn(q, k[:, :16], v[:, :16], window=8)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA device and nvcc: the kernel against its plain
    version on ragged, windowed, non-causal and GQA cases in fp32
    (IEEE, TF32 off) and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [((1, 200, 8, 2, 32), True, None), ((2, 64, 2, 1, 128), False,
                                                  None),
             ((1, 160, 4, 2, 32), True, 16), ((1, 300, 8, 2, 80), True, 64),
             ((2, 256, 4, 4, 64), False, 1000)]
    for shape, causal, window in cases:
        arrays = qkv(*shape)
        for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in arrays)
            before = fa.LAUNCHES
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert fa.LAUNCHES == before + 1
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=atol, rtol=atol)
