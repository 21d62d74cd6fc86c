"""The mega-batch predict recurrence on tensors: kernel and plain version.

:class:`repro_torch.core.megabatch.MegaBatch` compiles K candidate
engines into ``(T, K)`` step arrays; this module evaluates the step
recurrence

    start            = max over 3 deps of (ends[dep[j]] + delay[j])
    starts[out[j]]   = start
    ends[out[j]]     = start + dur[j]

in float64 on tensors that already lie on one device, and returns the
per-slot ``(ends, starts)`` vectors on that device.

* ``backend="cuda"`` — the hand-written Hopper kernel
  (``csrc/megabatch_scan.cu``; it replaces the reference package's TPU
  kernel ``kernels/megabatch_scan.py::_scan_pallas``): one launch,
  one thread per lane, each looping over its own steps. Compiled with
  ``nvcc`` for ``sm_90a`` at first use. A build or launch failure
  raises; nothing gives way to the plain version.
* ``backend="torch"`` — the plain PyTorch version: a Python loop over T
  of gather / add / 3-way max / index-put, on any device. It is what
  the CPU tests run and what the kernel is held against on the card.
* ``backend="auto"`` — the kernel for CUDA tensors, the plain version
  for CPU tensors (and only because they lie on the CPU).

Both are bit-identical to the NumPy reference
(:meth:`MegaBatch._eval_numpy`): the arithmetic is ``+`` and ``max`` on
doubles. Programs are NaN-free by construction.

Raggedness: ``lengths[k]`` is the number of live steps of lane ``k``
(rows ``j >= lengths[k]`` are padding). Both versions stop a lane at
its length, so padding is neither read nor written; without
``lengths`` every lane walks all T rows, padding included.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

SCAN_BACKENDS = ("auto", "torch", "cuda")

#: times the CUDA kernel was launched by :func:`scan_steps` (and nothing
#: else adds to it): lets a run show that it went through the kernel
LAUNCHES = 0

#: threads per block: one warp, so K lanes spread over as many SMs as
#: possible — the kernel is latency-bound, not occupancy-bound
THREADS = 32

_INT32_MAX = 2 ** 31 - 1


def _check(out, dep, delay, dur, n_slots, lengths, index_dtypes) -> None:
    """Raise on anything the implementations do not take."""
    if out.dim() != 2:
        raise ValueError(f"out must be (T, K); got {tuple(out.shape)}")
    T, K = out.shape
    want = {"out": (out, (T, K)), "dep": (dep, (T, K, 3)),
            "delay": (delay, (T, K, 3)), "dur": (dur, (T, K))}
    if lengths is not None:
        want["lengths"] = (lengths, (K,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must have shape {shape}; got {tuple(t.shape)}")
        if t.device != out.device:
            raise ValueError(
                f"{name} lies on {t.device}, out on {out.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("out", "dep") + (("lengths",) if lengths is not None
                                  else ()):
        t = want[name][0]
        if t.dtype not in index_dtypes:
            raise TypeError(
                f"{name} must be one of {index_dtypes}; got {t.dtype}")
    for name in ("delay", "dur"):
        t = want[name][0]
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64; got {t.dtype}")
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1; got {n_slots}")


def scan_steps(out: torch.Tensor, dep: torch.Tensor, delay: torch.Tensor,
               dur: torch.Tensor, n_slots: int, backend: str = "auto",
               lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the step recurrence; returns float64 ``(ends, starts)``
    tensors of length ``n_slots`` on the inputs' device, indexed by
    slot (``starts[out[j, k]]`` is the start of step j of lane k)."""
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"unknown scan backend {backend!r}; "
                         f"choose from {SCAN_BACKENDS}")
    if backend == "auto":
        backend = "cuda" if out.is_cuda else "torch"
    if backend == "cuda":
        if not out.is_cuda:
            raise ValueError(
                "backend='cuda' needs tensors on a CUDA device; these "
                f"lie on {out.device} (use backend='torch' on the CPU)")
        return _scan_cuda(out, dep, delay, dur, n_slots, lengths)
    return _scan_torch(out, dep, delay, dur, n_slots, lengths)


def _scan_torch(out, dep, delay, dur, n_slots, lengths=None):
    """Plain PyTorch version: T steps, each a (K, 3) gather, an add, a
    row max and two index-puts. Lanes past their length rewrite the
    value their slot already holds, so shapes stay static (no
    device-to-host sync per step)."""
    _check(out, dep, delay, dur, n_slots, lengths,
           (torch.int32, torch.int64))
    T, K = out.shape
    ends = torch.zeros(n_slots, dtype=torch.float64, device=out.device)
    starts = torch.zeros(n_slots, dtype=torch.float64, device=out.device)
    if T == 0 or K == 0:
        return ends, starts
    for j in range(T):
        start = (ends[dep[j].long()] + delay[j]).max(dim=-1).values
        end = start + dur[j]
        o = out[j].long()
        if lengths is not None:
            live = lengths > j
            start = torch.where(live, start, starts[o])
            end = torch.where(live, end, ends[o])
        starts[o] = start
        ends[o] = end
    return ends, starts


_lib = None


def _library():
    """The compiled kernel, built at first use."""
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load_kernel
        lib = load_kernel("megabatch_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.megabatch_scan_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.megabatch_scan_launch.restype = i
        lib.megabatch_scan_error_string.argtypes = [i]
        lib.megabatch_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _scan_cuda(out, dep, delay, dur, n_slots, lengths=None):
    """Wrapper of the CUDA kernel: checks its inputs, allocates the
    outputs, launches on the current stream and checks the launch. It
    does not synchronise."""
    global LAUNCHES
    _check(out, dep, delay, dur, n_slots, lengths, (torch.int32,))
    if n_slots > _INT32_MAX:
        raise ValueError(
            f"n_slots = {n_slots} does not fit the kernel's int32 slot "
            f"indices (at most {_INT32_MAX})")
    T, K = out.shape
    # torch.zeros, not empty: slot 0 must read 0.0
    ends = torch.zeros(n_slots, dtype=torch.float64, device=out.device)
    starts = torch.zeros(n_slots, dtype=torch.float64, device=out.device)
    if T == 0 or K == 0:
        return ends, starts
    if lengths is None:
        lengths = torch.full((K,), T, dtype=torch.int32, device=out.device)
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.megabatch_scan_launch(
            out.data_ptr(), dep.data_ptr(), delay.data_ptr(),
            dur.data_ptr(), lengths.data_ptr(), ends.data_ptr(),
            starts.data_ptr(), T, K, THREADS, stream)
    if err != 0:
        msg = lib.megabatch_scan_error_string(err).decode()
        raise RuntimeError(
            f"megabatch_scan kernel launch failed: {msg} (cudaError {err})")
    LAUNCHES += 1
    return ends, starts
