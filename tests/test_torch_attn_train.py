"""The training attention's kernels (``kernels.flash_attention_train``):
the dispatch rule, the pairs its FLOP formula counts against the plain
attention's ``_block_pairs``, a traced call's records, and, on the
card, the pair table the kernels make against ``_block_pairs`` at their
tiles and the kernels' out, lse, dq, dk and dv against the plain
blockwise attention (``_flash_fwd_impl`` / ``_flash_bwd_impl`` through
``_FlashCore``) on the same bf16 inputs.

On the card both are held to an fp32 truth: the plain version on the
inputs upcast to fp32 (TF32 off). The kernels round P and dS to bf16 at
the plain version's points and sum everything else in fp32 (where the
plain version rounds each block's P·V, dS·K, dSᵀ·Q and Pᵀ·dO to bf16
and adds the GQA heads in bf16), so each of their results must lie as
close to the truth as the plain bf16 version's, with a margin of a
quarter for the other tiles at which P is rounded. lse, computed from
exact bf16 products in fp32 on both sides, is held directly: the
kernels' exp2 and log2 approximations (2 ulp) and summation order leave
about 1e-6 of it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_train as fat
from repro_torch.models import layers as L


def _arange(b, s, offset=0):
    return torch.arange(s).expand(b, s) + offset


def _positions(case):
    """(q_pos, k_pos, causal, window) of a named case, both (B, S)."""
    if case == "arange":
        return _arange(2, 300), _arange(2, 300), True, None
    if case == "h2o":
        return _arange(2, 4096), _arange(2, 4096), True, 4096
    if case == "offset":          # a chunk of queries late in a sequence
        return _arange(2, 200, 700), _arange(2, 900), True, None
    if case == "q_padding":       # the last queries padding (-1)
        qp = _arange(2, 333).clone()
        qp[:, -70:] = -1
        return qp, _arange(2, 333), True, None
    if case == "kv_padding":      # the last keys empty slots (2**30)
        kp = _arange(2, 333).clone()
        kp[:, -90:] = 2 ** 30
        return _arange(2, 333), kp, True, 100
    if case == "windowed":
        return _arange(1, 1000), _arange(1, 1000), True, 129
    if case == "non_causal":
        return _arange(2, 260), _arange(2, 260), False, None
    if case == "cross":           # Sq != Sk, bidirectional
        return _arange(2, 130), _arange(2, 515), False, None
    if case == "rows_differ":     # each batch row its own offset
        qp = torch.stack([torch.arange(256), torch.arange(256) + 300])
        kp = torch.stack([torch.arange(600), torch.arange(600)])
        return qp, kp, True, 200
    raise ValueError(case)


CASES = ["arange", "h2o", "offset", "q_padding", "kv_padding", "windowed",
         "non_causal", "cross", "rows_differ"]


@pytest.mark.parametrize("case", ["arange", "h2o", "windowed",
                                  "non_causal", "cross"])
def test_visited_pairs_are_block_pairs_not_skipped(case):
    """The pairs the FLOP formulas count at positions 0..S-1 are those
    ``_block_pairs`` does not skip at the kernels' tiles."""
    qp, kp, causal, window = _positions(case)
    table = L._block_pairs(qp, kp, causal, window, fat.TILE_Q, fat.TILE_KV)
    assert fat.visited_pairs(qp.shape[1], kp.shape[1], causal, window) == \
        sum(kind != fat.SKIP for row in table for kind in row)


def _qkv(dtype, hd, b=1, s=16, h=8, kh=2, device="cpu"):
    return (torch.zeros((b, s, h, hd), dtype=dtype, device=device),
            torch.zeros((b, s, kh, hd), dtype=dtype, device=device),
            torch.zeros((b, s, kh, hd), dtype=dtype, device=device))


def _narrow_heads(device, b=1, s=16, h=8, kh=2):
    """Views of the first 64 of 68 features a head: a head stride of 136
    bytes, which a TMA map cannot describe."""
    return tuple(torch.empty_strided((b, s, n, 64), (s * n * 68, n * 68, 68,
                                                     1),
                                     dtype=torch.bfloat16, device=device)
                 for n in (h, kh, kh))


DISPATCH = {
    "bf16-hd80": (lambda d: _qkv(torch.bfloat16, 80, device=d), True),
    "fp32": (lambda d: _qkv(torch.float32, 80, device=d), False),
    "bf16-hd40": (lambda d: _qkv(torch.bfloat16, 40, device=d), False),
    "bf16-hd16": (lambda d: _qkv(torch.bfloat16, 16, device=d), False),
    "bf16-head-stride-not-16-bytes": (_narrow_heads, True),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_rule(name):
    """A CPU tensor never takes the kernels, whatever its dtype and
    shape; nor a window of 0."""
    q, k, v = DISPATCH[name][0]("cpu")
    assert not fat.takes(q, k, v)
    assert not fat.takes(q, k, v, window=0)


@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_rule_on_cuda_tensors(name):
    """The rule's dtype and shape half, on fake CUDA tensors inside
    ``traced_kernels``: bf16 at a head_dim in ``TC_HEAD_DIMS`` takes the
    kernels, strides that a TMA map cannot describe included (the
    kernels read a contiguous copy); fp32 and other head dims do not."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    make, expected = DISPATCH[name]
    with FakeTensorMode():
        q, k, v = make("cuda")
    assert q.device.type == "cuda"
    with fat.traced_kernels():
        assert fat.takes(q, k, v) is expected
        assert not fat.takes(q, k, v, window=0)
    assert not fat.takes(q, k, v)


def test_fake_tensors_take_the_plain_version():
    """The dry run's traced step (fake tensors, even on a CUDA device)
    counts the plain version's work."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((1, 256, 8, 80), dtype=torch.bfloat16,
                        device="cuda")
        k = torch.empty((1, 256, 2, 80), dtype=torch.bfloat16,
                        device="cuda")
    assert q.device.type == "cuda" and not fat.takes(q, k, k)


def test_a_traced_call_counts_the_kernels():
    """On fake CUDA tensors the kernels are one op each: its FLOPs the
    formulas' (``roofline.CUSTOM_FLOPS``, which ``FlopCounterMode``
    counts alike), its bytes its inputs and outputs, and its outputs
    the shapes the kernels write."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import roofline
    b, s, h, kh, hd = 2, 600, 8, 2, 64
    counter = roofline.TraceCounter()
    with counter:
        q = torch.empty((b, s, h, hd), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((b, s, kh, hd), dtype=torch.bfloat16, device="cuda")
        v = torch.empty_like(k)
        pos = torch.arange(s, device="cuda").expand(b, s)
        counter.counting = True
        flops = FlopCounterMode(display=False,
                                custom_mapping=roofline.CUSTOM_FLOPS)
        with flops:
            out, lse, kinds = fat.forward(q, k, v, pos, pos, True, 200)
            dq, dk, dv = fat.backward(q, k, v, pos, pos, kinds, out, lse,
                                      out, True, 200)
    assert out.shape == q.shape and dq.shape == q.shape
    assert dk.shape == dv.shape == k.shape and dk.dtype == torch.bfloat16
    assert lse.shape == (b, h, 640) and lse.dtype == torch.float32
    assert kinds.shape == (10, 5) and kinds.dtype == torch.uint8
    fwd, bwd = sorted(counter.records, key=lambda r: r.op, reverse=True)
    assert fwd.op == "repro_torch.attn_train_fwd.default"
    assert bwd.op == "repro_torch.attn_train_bwd.default"
    pairs = fat.visited_pairs(s, s, True, 200)
    tile = 2 * b * h * fat.TILE_Q * fat.TILE_KV * hd * pairs
    assert fwd.flops == 2 * tile and bwd.flops == 7 * tile
    assert flops.get_total_flops() == 9 * tile
    qb, kb, pb = q.numel() * 2, k.numel() * 2, s * 8   # pos: batch stride 0
    assert fwd.bytes == qb + 2 * kb + 2 * pb + qb + lse.numel() * 4 + 50
    assert bwd.bytes == (3 * qb + 2 * kb + 2 * pb + 50 + lse.numel() * 4
                         + qb + 2 * kb)


def test_cpu_calls_run_the_plain_version(monkeypatch):
    """On CPU tensors ``attention_flash_torch`` runs ``_FlashCore``,
    bf16 and hd 80 included, and never the kernels' Function."""
    def refuse(*args):
        raise AssertionError("the kernels' Function ran on the CPU")
    monkeypatch.setattr(L._FlashKernels, "apply", refuse)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 96, 4, 80), generator=g).bfloat16().requires_grad_()
    k = torch.randn((1, 96, 2, 80), generator=g).bfloat16().requires_grad_()
    pos = _arange(1, 96)
    out = L.attention_flash_torch(q, k, k, pos, pos, True, None, 32, 64)
    out.float().sum().backward()
    assert out.shape == q.shape and q.grad is not None


# ------------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


#: (B, Sq, Sk, H, KH, hd, positions case or None for arange, causal,
#: window): h2o's training layer, the families' (qwen3 n_rep 8 hd 64,
#: jamba hd 128, t5 bidirectional and its cross-attention), a ragged S,
#: and positions that are not arange
KERNEL_CASES = {
    "h2o_train": (2, 4096, 4096, 32, 8, 80, None, True, 4096),
    "qwen3": (1, 2048, 2048, 32, 4, 64, None, True, None),
    "jamba": (1, 2048, 2048, 32, 8, 128, None, True, None),
    "t5_self": (2, 1024, 1024, 16, 16, 64, None, False, None),
    "t5_cross": (2, 512, 1024, 16, 16, 64, None, False, None),
    "ragged": (1, 1000, 1000, 8, 2, 80, None, True, 300),
    "hd32": (1, 520, 520, 4, 2, 32, None, True, None),
    "hd96": (1, 700, 700, 6, 3, 96, None, True, 257),
    "offset": (2, 200, 900, 8, 2, 80, "offset", True, None),
    "q_padding": (2, 333, 333, 8, 2, 80, "q_padding", True, None),
    "kv_padding": (2, 333, 333, 8, 2, 64, "kv_padding", True, 100),
    "rows_differ": (2, 256, 600, 8, 4, 80, "rows_differ", True, 200),
}


def _plain(q, k, v, qp, kp, causal, window, dout):
    """The plain version on the card: out and lse of ``_flash_fwd_impl``
    and dq, dk, dv of ``_FlashCore``'s backward (``per_kv_head``
    included)."""
    bq, bkv = min(512, q.shape[1]), min(1024, k.shape[1])
    n_rep = q.shape[2] // k.shape[2]
    pairs = L._block_pairs(qp, kp, causal, window, bq, bkv)
    with torch.no_grad():
        out, lse = L._flash_fwd_impl(
            L._heads(q, 1, bq), L._heads(k, n_rep, bkv),
            L._heads(v, n_rep, bkv), qp, kp, causal, window, bq, bkv, pairs)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = L._FlashCore.apply(*leaves, qp, kp, causal, window, bq, bkv)
    o.backward(dout)
    sq = q.shape[1]
    return (out[:, :, :sq].transpose(1, 2), lse[:, :, :sq],
            *(t.grad for t in leaves))


def _rel(got, want, rows=None):
    got, want = got.detach().double(), want.detach().double()
    if rows is not None:
        got, want = got[rows], want[rows]
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernels_match_the_plain_version_on_the_card(name):
    """Needs a CUDA device and nvcc: out, lse, dq, dk, dv of the kernels
    against the plain version on the same bf16 inputs, both held to the
    fp32 truth as the module's docstring states; rows that see no key
    (undefined in the plain version) are left out of out and lse."""
    _card()
    b, sq, sk, h, kh, hd, case, causal, window = KERNEL_CASES[name]
    if case is None:
        qp, kp = _arange(b, sq), _arange(b, sk)
    else:
        qp, kp, causal, window = _positions(case)
    qp, kp = qp.cuda(), kp.cuda()
    g = torch.Generator("cuda").manual_seed(sq + sk + hd)
    q = torch.randn((b, sq, h, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, sk, kh, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, sk, kh, hd), generator=g, device="cuda").bfloat16()
    dout = torch.randn((b, sq, h, hd), generator=g,
                       device="cuda").bfloat16()
    assert fat.takes(q, k, v)

    before = dict(telemetry.COUNTS)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = L.attention_flash_torch(*leaves, qp, kp, causal, window)
    out.backward(dout)
    _, lse, kinds = fat.forward(q, k, v, qp, kp, causal, window)
    torch.cuda.synchronize()
    assert telemetry.COUNTS["attn_train.fwd"] == \
        before.get("attn_train.fwd", 0) + 2
    assert telemetry.COUNTS["attn_train.bwd"] == \
        before.get("attn_train.bwd", 0) + 1
    assert telemetry.COUNTS.get("host_sync", 0) == \
        before.get("host_sync", 0)
    assert kinds.tolist() == L._block_pairs(qp, kp, causal, window,
                                            fat.TILE_Q, fat.TILE_KV)
    got = [out, lse.transpose(1, 2)[:, :sq]] + [t.grad for t in leaves]

    plain = list(_plain(q, k, v, qp, kp, causal, window, dout))
    plain[1] = plain[1].transpose(1, 2)
    truth = list(_plain(q.float(), k.float(), v.float(), qp, kp, causal,
                        window, dout.float()))
    truth[1] = truth[1].transpose(1, 2)

    d = qp[:, :, None] - kp[:, None, :]
    seen = (qp[:, :, None] >= 0) & (kp[:, None, :] < 2 ** 29)
    if causal:
        seen &= d >= 0
    if window is not None:
        seen &= d < window
    rows = seen.any(-1)                                  # (B, Sq)
    for i, what in enumerate(("out", "lse", "dq", "dk", "dv")):
        assert got[i].shape == truth[i].shape, what
        assert torch.isfinite(got[i][rows] if i < 2 else got[i]).all(), what
        sel = rows if i < 2 else None
        if what == "lse":
            np.testing.assert_allclose(got[i][rows].cpu().numpy(),
                                       truth[i][rows].cpu().numpy(),
                                       atol=5e-5, rtol=1e-5)
            continue
        mine, theirs = _rel(got[i], truth[i], sel), _rel(plain[i], truth[i],
                                                         sel)
        assert mine <= 1.25 * theirs, (what, mine, theirs)
    if not rows.all():                 # no key: out 0, gradient 0
        assert not got[0][~rows].any() and not got[2][~rows].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_the_kernels_pair_table_is_block_pairs(case):
    """Needs a CUDA device: the table the kernels make on the device from
    the positions is ``_block_pairs``' at the kernels' tiles."""
    _card()
    qp, kp, causal, window = _positions(case)
    b, sq, sk = qp.shape[0], qp.shape[1], kp.shape[1]
    q = torch.zeros((b, sq, 4, 64), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((b, sk, 2, 64), dtype=torch.bfloat16, device="cuda")
    _, _, kinds = fat.forward(q, k, k, qp.cuda(), kp.cuda(), causal, window)
    assert kinds.tolist() == L._block_pairs(qp, kp, causal, window,
                                            fat.TILE_Q, fat.TILE_KV)


@pytest.mark.gpu
def test_the_kernels_read_a_strided_view_as_its_copy():
    """Needs a CUDA device: q, k and v whose head stride is no multiple
    of 16 bytes (views of 68-wide heads) run the kernels on a
    contiguous copy, with the bits of the kernels on that copy."""
    _card()
    b, s, h, kh = 2, 300, 8, 2
    g = torch.Generator("cuda").manual_seed(7)
    wide = [torch.randn((b, s, n, 68), generator=g, device="cuda").bfloat16()
            for n in (h, kh, kh)]
    dout = torch.randn((b, s, h, 64), generator=g, device="cuda").bfloat16()
    pos = _arange(b, s).cuda()
    before = telemetry.COUNTS.get("attn_train.fwd", 0)
    got = []
    for strided in (True, False):
        leaves = [(t.clone() if strided else t[..., :64].contiguous()
                   ).requires_grad_() for t in wide]
        qkv = [t[..., :64] for t in leaves]
        assert fat.takes(*qkv)
        assert fa.uses_tensor_cores(*qkv) is not strided
        out = L.attention_flash_torch(*qkv, pos, pos, True, 100)
        out.backward(dout)
        got.append([out] + [t.grad[..., :64] for t in leaves])
    assert telemetry.COUNTS["attn_train.fwd"] == before + 2
    for a, w in zip(*got):
        assert torch.equal(a, w)


@pytest.mark.gpu
def test_a_train_step_takes_the_kernels_and_never_syncs():
    """Needs a CUDA device: a small bf16 train step whose heads the
    kernels take (hd 64) launches the forward and the backward once a
    layer, counts no ``host_sync``, and CUDA's sync debug mode reports
    none either."""
    _card()
    import warnings
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(smoke_config(get_config("h2o_danube_1_8b")),
                              n_layers=3, d_model=256)
    opts = L.ModelOptions(dtype=torch.bfloat16, attn_impl="flash_torch",
                          remat=False)
    dev = torch.device("cuda")
    params = build_model(cfg, opts).init(torch.Generator(dev).manual_seed(0),
                                         dev)
    toks = torch.randint(1, cfg.vocab, (2, 512), device=dev)
    step = make_train_step(cfg, opts)
    args = (params, opt.init(params),
            {"tokens": toks, "labels": toks.roll(-1, 1)})
    step(*args)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, \
            telemetry.recording() as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, _, metrics = step(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    assert syncs == 0 and rec.counts[0].get("host_sync", 0) == 0
    assert rec.counts[0]["attn_train.fwd"] == cfg.n_layers
    assert rec.counts[0]["attn_train.bwd"] == cfg.n_layers
    assert torch.isfinite(metrics["loss"])
