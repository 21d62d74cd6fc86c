"""Row RMSNorm on tensors: kernel and plain version.

``x · rsqrt(mean(x²) + eps) · scale`` in fp32 over the last dimension,
cast back to the input dtype — what the reference package's TPU kernel
``kernels/rmsnorm.py::rmsnorm`` computes.

* :func:`rmsnorm_cuda` — the hand-written Hopper kernel
  (``csrc/rmsnorm.cu``), in the variant :func:`plan` picks: the
  register variant (a row held in registers by a group of threads,
  every thread the same number of 16-byte vectors, a persistent grid,
  the scale staged once a block) or, for rows outside that plan, the
  general variant (one block a row). Either reads each element from
  HBM once and writes it once. Compiled with ``nvcc`` for ``sm_90a`` at
  first use. A build or launch failure raises.
* :func:`rmsnorm_plain` — the plain PyTorch version, on any device: what
  the CPU tests run and what the kernel is held against on the card.
* :func:`rmsnorm` — the kernel for CUDA tensors, the plain version for
  CPU tensors (and only because they lie on the CPU).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import telemetry
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.ref import rmsnorm_ref

# dtype codes of csrc/rmsnorm.cu
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SCALE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# variant codes of csrc/rmsnorm.cu
_VARIANT_CODES = {"rows": 0, "general": 1}

#: threads of a block of the register variant (kBlock), the widest row
#: group, and the most 16-byte vectors one thread holds (kVptMax)
BLOCK_THREADS = 256
VPT_MAX = 16


class Plan(NamedTuple):
    """How the kernel runs rows of one width: ``variant`` "rows" (the
    register variant: ``threads_per_row`` threads, a power of two up to
    :data:`BLOCK_THREADS`, each holding ``vpt`` vectors of ``vec``
    elements; ``rows_per_block`` rows in flight a block) or "general"
    (one block of ``threads_per_row`` threads a row; ``vpt`` 0)."""
    variant: str
    vec: int
    vpt: int
    threads_per_row: int
    rows_per_block: int


@functools.lru_cache(maxsize=None)
def plan(d: int, x_dtype: torch.dtype, scale_dtype: torch.dtype,
         aligned: bool = True) -> Plan:
    """The variant for rows of width ``d`` of ``x_dtype`` with a scale of
    ``scale_dtype``; ``aligned``: x and out start on 16 bytes. The
    register variant takes a row of ``d / vec`` 16-byte vectors as
    ``vpt * threads_per_row`` of them with every lane equally loaded:
    the threads a row start at the largest power of two up to 32 that
    divides the vectors, and double while a thread would hold more than
    :data:`VPT_MAX`. Rows whose width is no whole number of vectors,
    that are misaligned, or that would need more than
    :data:`BLOCK_THREADS` threads (or a thread count that does not
    divide them) take the general variant."""
    if d < 1:
        raise ValueError(f"rows need a width >= 1; got {d}")
    if x_dtype not in _X_CODES:
        raise TypeError(f"the kernel takes x in {sorted(map(str, _X_CODES))}"
                        f"; got {x_dtype}")
    if scale_dtype not in _SCALE_CODES:
        raise TypeError(f"the kernel takes scale in "
                        f"{sorted(map(str, _SCALE_CODES))}; got {scale_dtype}")
    vec = 16 // x_dtype.itemsize
    if aligned and d % vec == 0:
        nvec = d // vec
        tpr = min(nvec & -nvec, 32)
        while (nvec // tpr > VPT_MAX and tpr < BLOCK_THREADS
               and nvec % (2 * tpr) == 0):
            tpr *= 2
        if nvec // tpr <= VPT_MAX:
            return Plan("rows", vec, nvec // tpr, tpr, BLOCK_THREADS // tpr)
    vectors = -(-d // vec)                  # one vector a thread, in warps
    return Plan("general", vec, 0, min(BLOCK_THREADS,
                                       -(-vectors // 32) * 32), 1)


#: the kernel's arithmetic in PyTorch, on any device
rmsnorm_plain = rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            block_rows: int = 128) -> torch.Tensor:
    """x: (..., d); scale: (d,). ``block_rows`` is the reference's row
    tile; rows are independent, so it changes no value here. Raises
    under autograd (:func:`~repro_torch.kernels.refuse_autograd`)."""
    refuse_autograd("rmsnorm", x, scale)
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1; got {block_rows}")
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


_lib = None


def _library():
    """The compiled kernel, built at first use."""
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load_kernel
        lib = load_kernel("rmsnorm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [p, p, p, i, i, ctypes.c_float, i, i,
                                       i, i, i, i, p]
        lib.rmsnorm_launch.restype = i
        lib.rmsnorm_error_string.argtypes = [i]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Wrapper of the CUDA kernel: checks its inputs, allocates the
    output, launches the variant :func:`plan` picks on x's device's
    current stream and checks the launch. It does not synchronise. Each
    launch counts in ``k3.launches`` (:mod:`repro_torch.telemetry`)."""
    refuse_autograd("rmsnorm_cuda", x, scale)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_cuda needs a CUDA tensor; x lies on "
                         f"{x.device}")
    if scale.device != x.device:
        raise ValueError(f"scale lies on {scale.device}, x on {x.device}")
    if x.dtype not in _X_CODES:
        raise TypeError(f"the kernel takes x in {sorted(map(str, _X_CODES))}"
                        f"; got {x.dtype}")
    if scale.dtype not in _SCALE_CODES:
        raise TypeError(f"the kernel takes scale in "
                        f"{sorted(map(str, _SCALE_CODES))}; got {scale.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or tuple(scale.shape) != (d,):
        raise ValueError(f"x must be (..., d) and scale (d,); got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("the kernel takes contiguous x and scale")
    n = x.numel() // d if d else 0
    if n >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"{n} rows of width {d} exceed the kernel's int32 "
                         f"grid")
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    lib = _library()
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    p = plan(d, x.dtype, scale.dtype, (x_ptr | out_ptr) % 16 == 0)
    device = x.device.index
    # the raw handle of the device's current stream, as
    # torch.cuda.current_stream(device).cuda_stream gives it but without
    # building a Stream object a call (the C entry makes the device
    # current for the launch)
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = lib.rmsnorm_launch(x_ptr, scale.data_ptr(), out_ptr, n, d,
                             float(eps), _X_CODES[x.dtype],
                             _SCALE_CODES[scale.dtype],
                             _VARIANT_CODES[p.variant], p.vpt,
                             p.threads_per_row, device, stream)
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(
            f"rmsnorm kernel launch failed: {msg} (cudaError {err})")
    telemetry.count("k3.launches")
    return out
