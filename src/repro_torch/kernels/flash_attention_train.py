"""Training attention on the card: the forward and the flash backward of
the blockwise attention (``models.layers.attention_flash_torch``) as
hand-written Hopper kernels (``csrc/flash_attention_train.cu``).

* :func:`takes` — the dispatch rule, decided from the inputs before any
  launch, as :func:`~repro_torch.kernels.flash_attention.uses_tensor_cores`
  decides K2's: real CUDA tensors on one device (a fake tensor of a
  traced step only inside :func:`traced_kernels`), bf16 q, k and v with
  a head_dim in ``TC_HEAD_DIMS``. Everything else runs the plain version
  in ``models.layers`` (``_flash_fwd_impl`` / ``_flash_bwd_impl``),
  which stays the oracle on the CPU.
* :func:`forward` — the (q tile, kv tile) table of SKIP / PARTIAL /
  FULL that the kernels read, made by a small kernel from the positions
  on the device (no copy to the host), then out (B, Sq, H, hd) and lse
  (B, H, Sq rounded up to 64) in fp32; :func:`backward` — dq, dk, dv in
  the inputs' layouts and dtype. Inputs whose strides a TMA tensor map
  cannot describe are copied to contiguous ones first.

Both are operators (``torch.ops.repro_torch.attn_train_fwd`` and
``attn_train_bwd``) with fake rules, so a step traced on fake tensors
(``core.roofline.TraceCounter``) sees each call as one op: its inputs
and outputs are its bytes, :func:`forward_flops` and
:func:`backward_flops` its FLOPs (``roofline.CUSTOM_FLOPS``, which
``FlopCounterMode`` takes too). Each launches on the current stream
and does not synchronise; a build or launch failure raises. Each call
on the card counts in ``attn_train.fwd`` or ``attn_train.bwd``
(:mod:`repro_torch.telemetry`).
"""
import contextlib
import ctypes

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import telemetry
from repro_torch.kernels import flash_attention as fa

#: query rows and keys of one entry of the pair table (the kernels' tiles)
TILE_Q, TILE_KV = 64, 128
#: how a (q tile, kv tile) pair is treated, as ``layers._block_pairs``
SKIP, PARTIAL, FULL = 0, 1, 2
#: products of a query head's (TILE_Q x TILE_KV x hd) tile pair that the
#: forward issues (S = QKᵀ, P·V) and the backward (Sᵀ, dPᵀ, dV, dK in the
#: dK/dV pass; S, dP, dQ again in the dQ pass)
FWD_PRODUCTS, BWD_PRODUCTS = 2, 7

_traced = False


@contextlib.contextmanager
def traced_kernels():
    """Inside, fake CUDA tensors take the kernels as real ones would, so
    a step traced on fake tensors counts the kernels' FLOPs, bytes and
    outputs, as the card runs that step. Outside, a trace runs the
    plain version: the work the reference's dry run is held to."""
    global _traced
    was, _traced = _traced, True
    try:
        yield
    finally:
        _traced = was


def takes(q, k, v, window=None) -> bool:
    """True where the kernels take the call: q (B, Sq, H, hd), k and v
    (B, Sk, KH, hd) with KH dividing H, real CUDA tensors on one device
    (a fake tensor holds no data; see :func:`traced_kernels`), all bf16,
    a head_dim in ``TC_HEAD_DIMS``, a grid the kernels can launch, and
    no window or one of at least 1. False sends the call to the plain
    version."""
    if window is not None and window < 1:
        return False
    if any((is_fake(t) and not _traced) or not t.is_cuda
           or t.device != q.device for t in (q, k, v)):
        return False
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        return False
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    if kh < 1 or h % kh or min(sq, k.shape[1]) < 1 \
            or max(sq, k.shape[1]) > 65535 * TILE_KV or b * h >= 2 ** 31:
        return False
    return hd in fa.TC_HEAD_DIMS and all(t.dtype == torch.bfloat16
                                         for t in (q, k, v))


def visited_pairs(sq, sk, causal, window) -> int:
    """The (q tile, kv tile) pairs the pair table leaves for a call at
    positions 0..S-1 (a training step's): those not SKIP."""
    q0 = np.arange(0, sq, TILE_Q)
    k0 = np.arange(0, sk, TILE_KV)
    q1, k1 = np.minimum(q0 + TILE_Q, sq) - 1, np.minimum(k0 + TILE_KV, sk) - 1
    some = np.ones((len(q0), len(k0)), dtype=bool)
    if causal:
        some &= k0[None] <= q1[:, None]
    if window is not None:
        some &= q0[:, None] - k1[None] < window
    return int(some.sum())


def _flops(products, q_shape, k_shape, causal, window) -> int:
    b, sq, h, hd = q_shape
    return (2 * products * b * h * TILE_Q * TILE_KV * hd
            * visited_pairs(sq, k_shape[1], causal, window))


def forward_flops(q_shape, k_shape, v_shape, q_pos_shape, k_pos_shape,
                  causal, window, out_shape=None, **_) -> int:
    """The forward's FLOPs as it issues them: whole tiles, each visited
    pair of each query head (:func:`visited_pairs`). A formula for
    ``FlopCounterMode`` (tensors given by their shapes)."""
    return _flops(FWD_PRODUCTS, q_shape, k_shape, causal, window)


def backward_flops(q_shape, k_shape, *args, out_shape=None, **_) -> int:
    """The backward's FLOPs, as :func:`forward_flops` counts the
    forward's."""
    causal, window = args[-2:]
    return _flops(BWD_PRODUCTS, q_shape, k_shape, causal, window)


_lib = None


def _library():
    """The compiled kernels, built at first use (one ``nvcc``)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load_kernel
        lib = load_kernel("flash_attention_train")
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        strides = ctypes.POINTER(ctypes.c_longlong)
        # causal, window, scale, q_pos, its batch stride, k_pos, its
        # batch stride, kinds, stream
        masks = [i, ll, f, p, ll, p, ll, p, p]
        lib.attn_train_fwd_launch.argtypes = [
            p, p, p, p, p, strides, i, i, i, i, i, i, *masks]
        lib.attn_train_fwd_launch.restype = i
        lib.attn_train_bwd_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, p, strides, i, i, i, i, i, i, *masks]
        lib.attn_train_bwd_launch.restype = i
        lib.attn_train_error_string.argtypes = [i]
        lib.attn_train_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _positions(pos):
    """int64 positions with unit stride along the sequence, and their
    batch stride (0 where every row shares them)."""
    pos = pos.long()
    if pos.stride(1) != 1:
        pos = pos.contiguous()
    return pos, pos.stride(0)


def _tma_ready(t):
    """``t`` as the kernels read it: itself where a TMA map can describe
    its strides (:func:`fa.uses_tensor_cores`), else a contiguous copy
    (the training step's q, k, v, out and dout are contiguous)."""
    if fa.uses_tensor_cores(t, t, t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _masks(q, q_pos, k_pos, kinds, causal, window):
    """The launch's mask arguments, and the position tensors they point
    into (a conversion's result must outlive the launch call; the
    allocator orders its reuse after the kernel on the stream)."""
    qp, qsb = _positions(q_pos)
    kp, ksb = _positions(k_pos)
    args = (int(causal), window if window is not None else 0,
            float(q.shape[-1] ** -0.5), qp.data_ptr(), qsb, kp.data_ptr(),
            ksb, kinds.data_ptr())
    return args, (qp, kp)


def _check(err, what):
    if err != 0:
        msg = _library().attn_train_error_string(err).decode()
        raise RuntimeError(f"training attention {what} kernel launch "
                           f"failed: {msg} (cudaError {err})")


def _stream(t):
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def forward(q, k, v, q_pos, k_pos, causal, window):
    """out (B, Sq, H, hd) in q's dtype, lse (B, H, Sq') fp32, Sq' = Sq
    rounded up to 64 (the rows past Sq are padding), and the pair table
    (uint8 (ceil(Sq / 64), ceil(Sk / 128)), ``layers._block_pairs``' rule
    at those tiles) for :func:`backward`."""
    return torch.ops.repro_torch.attn_train_fwd(q, k, v, q_pos, k_pos,
                                                causal, window)


def backward(q, k, v, q_pos, k_pos, kinds, out, lse, dout, causal,
             window):
    """dq like q, dk and dv like k, in q's dtype, from :func:`forward`'s
    out, lse and pair table and the output's gradient ``dout``."""
    return torch.ops.repro_torch.attn_train_bwd(
        q, k, v, q_pos, k_pos, kinds, out, lse, dout, causal, window)


def _forward_cuda(q, k, v, q_pos, k_pos, causal, window):
    q, k, v = map(_tma_ready, (q, k, v))
    out, lse, kinds = _forward_outputs(q, k)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    masks, keep_alive = _masks(q, q_pos, k_pos, kinds, causal, window)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    err = _library().attn_train_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides, b, h, h // kh, sq, sk, hd, *masks,
        _stream(q))
    _check(err, "forward")
    telemetry.count("attn_train.fwd")
    return out, lse, kinds


def _forward_outputs(q, k, *_):
    b, sq, h, hd = q.shape
    nq = -(-sq // TILE_Q)
    return (q.new_empty((b, sq, h, hd)),
            q.new_empty((b, h, nq * TILE_Q), dtype=torch.float32),
            q.new_empty((nq, -(-k.shape[1] // TILE_KV)), dtype=torch.uint8))


def _backward_cuda(q, k, v, q_pos, k_pos, kinds, out, lse, dout, causal,
                   window):
    q, k, v, out = map(_tma_ready, (q, k, v, out))
    dout = _tma_ready(dout.to(q.dtype))
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    delta = torch.empty_like(lse)
    dq, dk, dv = _backward_outputs(q, k)
    masks, keep_alive = _masks(q, q_pos, k_pos, kinds, causal, window)
    strides = (ctypes.c_longlong * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *dout.stride()[:3], *dq.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3])
    err = _library().attn_train_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, b, h, h // kh, sq, sk, hd,
        *masks, _stream(q))
    _check(err, "backward")
    telemetry.count("attn_train.bwd")
    return dq, dk, dv


def _backward_outputs(q, k, *_):
    return q.new_empty(q.shape), k.new_empty(k.shape), k.new_empty(k.shape)


# Operators by the dispatcher's own registration (``torch.library``'s
# ``custom_op`` wrapper imports much of torch's compiler stack at its
# first call: seconds of every run's set-up).
_OPS = torch.library.Library("repro_torch", "DEF")
_OPS.define("attn_train_fwd(Tensor q, Tensor k, Tensor v, Tensor q_pos, "
            "Tensor k_pos, bool causal, int? window) -> (Tensor, Tensor, "
            "Tensor)")
_OPS.define("attn_train_bwd(Tensor q, Tensor k, Tensor v, Tensor q_pos, "
            "Tensor k_pos, Tensor kinds, Tensor out, Tensor lse, "
            "Tensor dout, bool causal, int? window) -> (Tensor, Tensor, "
            "Tensor)")
_OPS.impl("attn_train_fwd", _forward_cuda, "CUDA")
_OPS.impl("attn_train_bwd", _backward_cuda, "CUDA")
torch.library.register_fake("repro_torch::attn_train_fwd",
                            _forward_outputs, lib=_OPS)
torch.library.register_fake("repro_torch::attn_train_bwd",
                            _backward_outputs, lib=_OPS)
