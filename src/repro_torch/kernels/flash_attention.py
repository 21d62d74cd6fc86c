"""Forward flash attention on tensors: kernel and plain version.

What the reference package's TPU kernel
``kernels/flash_attention.py::flash_attention_bh`` computes, on the
model's ``(B, S, H, hd)`` layout with grouped-query KV heads (query head
``h`` reads KV head ``h // n_rep``). Positions are the row indices
``0..Sq-1`` and ``0..Sk-1`` (Sk may differ from Sq only in a
non-causal, unwindowed call: cross-attention): scores ``q·kᵀ·hd^-0.5``
in fp32, masked by kv padding, ``causal`` (``q_pos >= k_pos``) and
``window`` (``q_pos - k_pos < window``), online softmax, output
``acc / max(l, 1e-30)`` in the input dtype.

* :func:`flash_attention_cuda` — the hand-written Hopper kernels, one
  block per (batch·head, q tile) with the kv loop inside, band-outside kv
  tiles skipped, KV heads and the layout read in place through strides.
  Which of two kernels runs is a rule on dtype and shape, decided before
  any launch (:func:`uses_tensor_cores`):

  - bf16 q, k, v with head_dim 32, 64, 80, 96 or 128, 16-byte-aligned
    bases and (batch, seq, head) strides in multiples of 16 bytes go to
    the tensor-core kernel (``csrc/flash_attention_tc.cu``): TMA copies,
    ``wgmma`` products in bf16 with fp32 accumulators, P·V kept at fp32
    accuracy by splitting P into two bf16 terms;
  - fp32, and any bf16 input outside that rule (head_dim 40, a
    misaligned view), go to the scalar kernel (``csrc/flash_attention.cu``),
    IEEE fp32 on the CUDA cores.

  Both are compiled with ``nvcc`` for ``sm_90a`` at first use. A build or
  launch failure of either raises; neither falls back to the other.
* :func:`flash_attention_plain` — the plain PyTorch version, on any
  device: the reference's blockwise algorithm (kv heads repeated, kv
  padded to whole blocks, every block walked and masked with -1e30).
  What the CPU tests run and what the kernel is held against on the
  card.
* :func:`flash_attention` — the kernel for CUDA tensors, the plain
  version for CPU tensors (and only because they lie on the CPU).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_autograd

#: times a CUDA kernel (either one) was launched by
#: :func:`flash_attention_cuda` (and nothing else adds to it): lets a run
#: show that it went through the kernels
LAUNCHES = 0
#: the tensor-core kernel's share of :data:`LAUNCHES`
TC_LAUNCHES = 0

NEG_INF = -1e30
#: widest head the kernel takes (its hd is padded to 32/64/80/96/128)
MAX_HEAD_DIM = 128

_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the tensor-core kernel takes (multiples of its 16-column
#: TMA box; :func:`uses_tensor_cores`)
TC_HEAD_DIMS = (32, 64, 80, 96, 128)


def _check_shapes(q, k, v, causal, window) -> int:
    """Raise on what no implementation takes; returns n_rep."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Sk, KH, hd) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    kh = k.shape[2]
    if kh < 1 or h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV "
                         f"heads")
    if k.shape[1] < 1:
        raise ValueError("k and v hold no position")
    if k.shape[1] != q.shape[1] and (causal or window is not None):
        # positions are the row indices 0..Sq-1 and 0..Sk-1; a causal or
        # windowed row may then see no key, where the kernel writes 0 and
        # the plain version a mean over masked keys. Non-causal rows see
        # all Sk keys (cross-attention), as in the reference.
        raise ValueError(f"q and k/v must share one sequence length; got "
                         f"Sq = {q.shape[1]}, Sk = {k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    return h // kh


def flash_attention_bh(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None, block_q: int = 128,
                       block_kv: int = 128) -> torch.Tensor:
    """Plain version on ``(BH, S, hd)`` tensors, the reference's
    algorithm: kv padded to whole blocks, walked block by block with the
    online softmax, every block masked (none skipped). Rows do not
    interact, so all query rows are processed together and ``block_q``
    changes no value."""
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"block sizes must be >= 1; got {block_q}, "
                         f"{block_kv}")
    sq, hd = q.shape[1], q.shape[2]
    sk = k.shape[1]
    block_kv = min(block_kv, max(8, sk))
    pk = (-sk) % block_kv
    qf = q.float()
    kf = F.pad(k.float(), (0, 0, 0, pk))
    vf = F.pad(v.float(), (0, 0, 0, pk))
    scale = hd ** -0.5
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full(qf.shape[:2], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, kf.shape[1], block_kv):
        kblk = kf[:, k0:k0 + block_kv]
        vblk = vf[:, k0:k0 + block_kv]
        s = torch.bmm(qf, kblk.transpose(1, 2)) * scale
        k_pos = torch.arange(k0, k0 + block_kv, device=q.device)[None, :]
        mask = k_pos < sk
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.bmm(p, vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, block_q: int = 128,
                          block_kv: int = 128) -> torch.Tensor:
    """Plain version on the model's layout: q (B,Sq,H,hd), k/v
    (B,Sk,KH,hd) → (B,Sq,H,hd). KV heads are repeated and the heads
    moved next to the batch, as the reference's ``ops`` wrapper does."""
    n_rep = _check_shapes(q, k, v, causal, window)
    b, sq, h, hd = q.shape
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    qb = q.transpose(1, 2).reshape(b * h, sq, hd)
    kb = k.transpose(1, 2).reshape(b * h, -1, hd)
    vb = v.transpose(1, 2).reshape(b * h, -1, hd)
    ob = flash_attention_bh(qb, kb, vb, causal=causal, window=window,
                            block_q=block_q, block_kv=block_kv)
    return ob.reshape(b, h, sq, hd).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors.
    The block sizes shape only the plain version's tiling. Raises under
    autograd (:func:`~repro_torch.kernels.refuse_autograd`)."""
    refuse_autograd("flash_attention", q, k, v)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 block_q=block_q, block_kv=block_kv)


def uses_tensor_cores(q, k, v) -> bool:
    """The dispatch rule of :func:`flash_attention_cuda`: True where the
    tensor-core kernel takes the inputs — q, k and v all bf16, a head_dim
    in :data:`TC_HEAD_DIMS`, unit head_dim stride, base addresses on 16
    bytes and positive (batch, seq, head) strides in multiples of 16
    bytes (what a TMA tensor map can describe). False sends them to the
    scalar kernel. Decided from dtype and shape alone, before any
    launch."""
    if q.shape[-1] not in TC_HEAD_DIMS:
        return False
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.stride(3) != 1 \
                or t.data_ptr() % 16:
            return False
        if any(st <= 0 or (st * t.element_size()) % 16
               for st in t.stride()[:3]):
            return False
    return True


_lib = None


def _library():
    """The compiled kernels ``{"scalar": ..., "tc": ...}``, built at
    first use (one ``nvcc`` each, in parallel)."""
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load_kernels
        libs = load_kernels(["flash_attention", "flash_attention_tc"])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_longlong)
        scalar, tc = libs["flash_attention"], libs["flash_attention_tc"]
        scalar.flash_attention_launch.argtypes = [
            p, p, p, p, strides, i, i, i, i, i, i, i, i, f, i, p]
        scalar.flash_attention_launch.restype = i
        scalar.flash_attention_error_string.argtypes = [i]
        scalar.flash_attention_error_string.restype = ctypes.c_char_p
        tc.flash_attention_tc_launch.argtypes = [
            p, p, p, p, strides, i, i, i, i, i, i, i, i, f, p]
        tc.flash_attention_tc_launch.restype = i
        tc.flash_attention_tc_smem_bytes.argtypes = [i]
        tc.flash_attention_tc_smem_bytes.restype = i
        tc.flash_attention_tc_error_string.argtypes = [i]
        tc.flash_attention_tc_error_string.restype = ctypes.c_char_p
        _lib = {"scalar": scalar, "tc": tc}
    return _lib


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Wrapper of the CUDA kernels: checks the inputs, allocates the
    output, launches the kernel :func:`uses_tensor_cores` picks on the
    current stream and checks the launch. It does not synchronise."""
    global LAUNCHES, TC_LAUNCHES
    refuse_autograd("flash_attention_cuda", q, k, v)
    n_rep = _check_shapes(q, k, v, causal, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_cuda needs q, k, v on one "
                             f"CUDA device; {name} lies on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _CODES:
            raise TypeError(f"the kernel takes q, k, v of one dtype in "
                            f"{sorted(map(str, _CODES))}; {name} is "
                            f"{t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit head_dim stride; "
                             f"strides {t.stride()}")
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}, the kernel's "
                         f"widest")
    if b * h > 65535 or max(sq, sk, window or 0) >= 2 ** 31:
        raise ValueError(f"B*H = {b * h} or a length exceeds the kernel's "
                         f"grid")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or sq == 0 or h == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    tc = uses_tensor_cores(q, k, v)
    lib = _library()["tc" if tc else "scalar"]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, h, n_rep, sq, sk, hd)
    masks = (int(causal), window if window is not None else 0,
             float(hd ** -0.5))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            err = lib.flash_attention_tc_launch(*args, *masks, stream)
            error_string = lib.flash_attention_tc_error_string
        else:
            err = lib.flash_attention_launch(*args, *masks,
                                             _CODES[q.dtype], stream)
            error_string = lib.flash_attention_error_string
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(
            f"flash_attention {'tensor-core' if tc else 'scalar'} kernel "
            f"launch failed: {msg} (cudaError {err})")
    LAUNCHES += 1
    TC_LAUNCHES += int(tc)
    return out
