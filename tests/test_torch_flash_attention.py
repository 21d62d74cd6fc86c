"""The port's flash attention (kernel module K2 and its ``ops`` wrapper)
against the reference's: the same inputs, made from a seed with numpy,
go through ``repro.kernels.ops.flash_attention`` (Pallas in interpret
mode on the CPU) and ``repro_torch.kernels.ops.flash_attention`` (its
plain PyTorch version on CPU tensors), on every parametrised case of
``tests/test_kernels.py`` plus the model's head_dim 80 with n_rep 4.

Bars are the reference's own: 2e-5 in fp32, 2e-2 in bf16. The kernels
themselves are held against the plain version on the card by the ``gpu``
case below and by ``chip_smoke.py``. Without a card, the tensor-core
kernel's arithmetic (bf16 products, P split into two bf16 terms for P·V)
is emulated with torch on the CPU and held to the card's two-bf16-ulp
bar, and its dispatch rule is pinned.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.telemetry import COUNTS

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
    before = COUNTS.get("k2.launches", 0)
    fa.flash_attention(q, k, v)
    assert COUNTS.get("k2.launches", 0) == before


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
    """k and v hold one key each a position: a k shorter than v (the
    query's length may differ from both) is refused before any
    implementation runs."""
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 32, 4, 2, 32))
    with pytest.raises(ValueError, match="matching q"):
        fn(q, k[:, :16], v, window=8)


def qkv_cross(b, sq, sk, h, kh, hd, seed=0):
    """Seeded q (B, Sq, H, hd) and k, v (B, Sk, KH, hd)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd), dtype=np.float32),
            rng.standard_normal((b, sk, kh, hd), dtype=np.float32),
            rng.standard_normal((b, sk, kh, hd), dtype=np.float32))


#: (Sq, Sk, causal, window) with Sq != Sk: cross-attention (non-causal,
#: no window), four causal or windowed shapes, and two windowed ones
#: with rows that see no key (Sq > Sk: rows q >= Sk - 1 + window;
#: Sk = 200 pads to 256, Sk = 5 to 8)
LENGTHS = [pytest.param(40, 72, False, None, id="40-72"),
           pytest.param(72, 40, False, None, id="72-40"),
           pytest.param(1000, 1500, False, None, id="1000-1500"),
           pytest.param(40, 72, True, None, id="40-72-causal"),
           pytest.param(72, 40, True, None, id="72-40-causal"),
           pytest.param(72, 40, False, 8, id="72-40-window8"),
           pytest.param(40, 72, True, 16, id="40-72-causal-window16"),
           pytest.param(300, 200, True, 16,
                        id="300-200-causal-window16-empty-rows"),
           pytest.param(40, 5, False, 4, id="40-5-window4-empty-rows")]


def empty_rows(sq, sk, window):
    """The query rows that see no key: q - (Sk - 1) >= window."""
    if window is None:
        return np.zeros(sq, bool)
    return np.arange(sq) - (sk - 1) >= window


@pytest.mark.parametrize("sq,sk,causal,window", LENGTHS)
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_cross_attention_lengths_match_the_reference(sq, sk, causal, window,
                                                     dtype, atol):
    """Attention with Sq != Sk (GQA n_rep 2) as the reference's kernel
    computes it: positions 0..Sq-1 and 0..Sk-1 aligned top-left, kv
    padded to the block and masked with k_pos < seq_k, then by
    ``causal`` and ``window``; a row that sees no key is the mean of V
    over the padded key range."""
    arrays = qkv_cross(1, sq, sk, 4, 2, 64, seed=sq + sk)
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    ro = np.asarray(ref_ops.flash_attention(
        *jx, causal=causal, window=window).astype(jnp.float32))
    tt = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    po = ops.flash_attention(*tt, causal=causal, window=window)
    assert po.dtype == TORCH[dtype] and po.shape == tt[0].shape
    np.testing.assert_allclose(po.float().numpy(), ro, atol=atol, rtol=atol)
    empty = empty_rows(sq, sk, window)
    if empty.any():
        v = arrays[2].astype(np.float64).repeat(2, axis=2)
        pad = -sk % min(128, max(8, sk))
        mean = v.sum(axis=1, keepdims=True) / (sk + pad)
        np.testing.assert_allclose(ro[:, empty], np.broadcast_to(
            mean, ro[:, empty].shape), atol=atol, rtol=atol)


#: what the attention still refuses: (Sq, Sk, causal, window)
REFUSED = [pytest.param(40, 0, True, None, "no position", id="no-keys"),
           pytest.param(40, 0, False, None, "no position",
                        id="no-keys-non-causal"),
           pytest.param(40, 72, True, 0, "window", id="window-0")]


@pytest.mark.parametrize("sq,sk,causal,window,match", REFUSED)
@pytest.mark.parametrize("fn", [fa.flash_attention, fa.flash_attention_cuda,
                                fa.flash_attention_plain])
def test_no_keys_or_a_window_below_one_are_refused(fn, sq, sk, causal,
                                                   window, match):
    """Any Sq and Sk >= 1 are taken; a k/v of no position and a window
    below one are refused before any implementation runs."""
    q, k, v = (torch.from_numpy(a) for a in qkv_cross(1, sq, sk, 4, 2, 32))
    with pytest.raises(ValueError, match=match):
        fn(q, k, v, causal=causal, window=window)


#: the tensor-core kernel against the plain version: both compute in
#: fp32 (P·V through the hi/lo split), so a bf16 output may differ by a
#: rounding step — two bf16 ulps; ``chip_smoke.py``'s K2_BF16_TOL
BF16_TWO_ULPS = {"atol": 1e-5, "rtol": 2.0 ** -6}


def tc_emulation(q, k, v, *, causal, window, split=True, block=128):
    """The tensor-core kernel's arithmetic with torch on CPU tensors:
    bf16 q and k upcast and multiplied in fp32 (bf16 products are exact
    in fp32), hd^-0.5·log2(e) folded into one scale with exp2, an online
    softmax over 128-key tiles, and P·V as P_hi·V + P_lo·V with P_hi =
    bf16(P), P_lo = bf16(P − P_hi) (``split=False``: P_hi·V alone, the
    single rounding). Returns the fp32 output before its bf16
    rounding."""
    b, s, h, hd = q.shape
    n_rep = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(n_rep, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(n_rep, 2).transpose(1, 2)
    scale = hd ** -0.5 * math.log2(math.e)
    pos = torch.arange(s)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, hd))
    for k0 in range(0, s, block):
        kp = pos[k0:k0 + block]
        ok = torch.ones((s, kp.numel()), dtype=torch.bool)
        if causal:
            ok &= kp[None, :] <= pos[:, None]
        if window is not None:
            ok &= pos[:, None] - kp[None, :] < window
        sc = qf @ kf[:, :, k0:k0 + block].transpose(-1, -2) * scale
        sc = torch.where(ok, sc, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        mu = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(sc - mu[..., None])
        l = l * alpha + p.sum(-1)
        vblk = vf[:, :, k0:k0 + block]
        p_hi = p.bfloat16().float()
        pv = p_hi @ vblk
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vblk
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)


@pytest.mark.parametrize("causal,window", [(True, 512), (False, None)])
def test_tensor_core_arithmetic_meets_the_two_ulp_bar(causal, window):
    """The model's head (hd 80, n_rep 4) at S = 1024: the emulated
    kernel meets two bf16 ulps against the plain version, and the split
    of P is what gets it there — its fp32 error is at least 10x below
    that of rounding P to bf16 once."""
    arrays = qkv(1, 1024, 8, 2, 80, seed=4)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    split = tc_emulation(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(split.bfloat16().float(), want.float(),
                               **BF16_TWO_ULPS)
    want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=causal, window=window)
    single = tc_emulation(q, k, v, causal=causal, window=window,
                          split=False)
    err_split = float((split - want32).abs().max())
    err_single = float((single - want32).abs().max())
    assert err_split * 10 <= err_single, (err_split, err_single)


def _fused_views(dtype=torch.bfloat16, hd=80):
    """q, k, v as strided views of one (B, S, (H + 2·KH)·hd) buffer:
    aligned, not contiguous."""
    h, kh = 8, 2
    buf = torch.zeros((2, 16, (h + 2 * kh) * hd), dtype=dtype)
    q = buf[..., :h * hd].unflatten(-1, (h, hd))
    k = buf[..., h * hd:(h + kh) * hd].unflatten(-1, (kh, hd))
    v = buf[..., (h + kh) * hd:].unflatten(-1, (kh, hd))
    return q, k, v


def _padded_rows():
    """A bf16 view whose sequence stride (8·80 + 4 elements, 1288
    bytes) is not a multiple of 16 bytes."""
    buf = torch.zeros((1, 16, 8 * 80 + 4), dtype=torch.bfloat16)
    q = buf[..., :8 * 80].unflatten(-1, (8, 80))
    return q, q[:, :, :2], q[:, :, 2:4]


def _plain(dtype, hd):
    return (torch.zeros((1, 16, 8, hd), dtype=dtype),
            torch.zeros((1, 16, 2, hd), dtype=dtype),
            torch.zeros((1, 16, 2, hd), dtype=dtype))


@pytest.mark.parametrize("inputs,expected", [
    (lambda: _plain(torch.bfloat16, 80), True),
    (_fused_views, True),
    (lambda: _plain(torch.float32, 80), False),
    (lambda: _plain(torch.bfloat16, 40), False),
    (_padded_rows, False),
], ids=["bf16-hd80-contiguous", "bf16-fused-buffer-views", "fp32",
        "bf16-hd40", "bf16-seq-stride-not-16-bytes"])
def test_dispatch_rule(inputs, expected):
    """Which kernel a CUDA call would launch, decided from dtype and
    shape alone (here on CPU tensors, which launch nothing)."""
    q, k, v = inputs()
    assert fa.uses_tensor_cores(q, k, v) is expected


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA device and nvcc: the kernels against their plain
    version on ragged, windowed, non-causal and GQA cases — fp32 (IEEE,
    TF32 off) through the scalar kernel at 2e-5, bf16 through the
    tensor-core kernel at two bf16 ulps, and bf16 at head_dim 40 through
    the scalar kernel; then non-causal cross-attention (Sq != Sk) through
    both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [((1, 200, 8, 2, 32), True, None), ((2, 64, 2, 1, 128), False,
                                                  None),
             ((1, 160, 4, 2, 32), True, 16), ((1, 300, 8, 2, 80), True, 64),
             ((2, 256, 4, 4, 64), False, 1000), ((1, 130, 4, 2, 40), True,
                                                  None)]
    for shape, causal, window in cases:
        arrays = qkv(*shape)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in arrays)
            tc = dtype == torch.bfloat16 and shape[-1] != 40
            assert fa.uses_tensor_cores(q, k, v) is tc
            tol = BF16_TWO_ULPS if dtype == torch.bfloat16 \
                else {"atol": 2e-5, "rtol": 2e-5}
            before = COUNTS.get("k2.launches", 0)
            tc_before = COUNTS.get("k2.tc_launches", 0)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert COUNTS.get("k2.launches", 0) == before + 1
            assert COUNTS.get("k2.tc_launches", 0) == \
                tc_before + int(tc)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)
    # Sq != Sk, neither a multiple of a tile: cross-attention, then
    # causal and windowed calls, rows that see no key among them
    for sq, sk, causal, window, hd in [
            (1000, 1500, False, None, 64), (1500, 1000, False, None, 128),
            (40, 72, False, None, 80), (40, 72, True, None, 80),
            (72, 40, True, None, 64), (72, 40, False, 8, 80),
            (40, 72, True, 16, 64), (300, 200, True, 16, 80),
            (1500, 1000, True, 300, 128)]:
        arrays = qkv_cross(1, sq, sk, 8, 2, hd, seed=sq)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in arrays)
            tc = dtype == torch.bfloat16
            assert fa.uses_tensor_cores(q, k, v) is tc
            tol = BF16_TWO_ULPS if tc else {"atol": 2e-5, "rtol": 2e-5}
            tc_before = COUNTS.get("k2.tc_launches", 0)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert COUNTS.get("k2.tc_launches", 0) == \
                tc_before + int(tc)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)
