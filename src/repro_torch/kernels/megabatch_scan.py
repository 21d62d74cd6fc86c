"""The mega-batch predict recurrence on tensors: kernel and plain versions.

:class:`repro_torch.core.megabatch.MegaBatch` compiles K candidate
engines into a program whose every row evaluates

    start            = max over 3 deps of (ends[dep] + delay)
    starts[out]      = start
    ends[out]        = start + dur

in float64; this module evaluates it on tensors that already lie on one
device and returns the per-slot ``(ends, starts)`` vectors there. It
takes the program in two layouts:

* :func:`scan_walks` — the *walk layout* (:class:`Walks`, built on the
  host by :func:`build_walks`): the live rows only, grouped per lane
  into walks, each in ascending step order. ``backend="cuda"`` is the
  hand-written Hopper kernel (``csrc/megabatch_scan.cu``; it replaces
  the reference package's TPU kernel
  ``kernels/megabatch_scan.py::_scan_pallas``): one launch, one block
  per lane, one thread per walk, dependencies between walks passed
  through ``ends`` with a NaN sentinel as the ready flag. Compiled with
  ``nvcc`` for ``sm_90a`` at first use. A build or launch failure
  raises, and so does a stalled wait (the kernel traps after 10 s);
  nothing gives way to the plain version. ``backend="torch"`` is the
  plain PyTorch version over the same layout: the rows in step order,
  one gather / add / 3-way max / index-put per step.
* :func:`scan_steps` — the padded ``(T, K)`` planes, the plain step
  loop only (what ``MegaBatch``'s ``torch`` backend runs).

``backend="auto"`` is the kernel for CUDA tensors and the plain version
for CPU tensors (and only because they lie on the CPU). Every version
is bit-identical to the NumPy reference
(:meth:`MegaBatch._eval_numpy`): the arithmetic is ``+`` and ``max`` on
doubles. Programs are NaN-free by construction.

Raggedness: ``lengths[k]`` is the number of live steps of lane ``k``
(rows ``j >= lengths[k]`` are padding). Without ``lengths`` the plain
step loop walks all T rows, padding included.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry

SCAN_BACKENDS = ("auto", "torch", "cuda")

#: most walks a lane may have: the kernel runs one thread per walk of a
#: lane in one block, and stages each walk's rows in shared memory
MAX_WALKS = 64

#: bit pattern of a not-yet-written ``ends`` slot: a signalling NaN,
#: which no arithmetic produces (the kernel's ready flag)
SENTINEL_BITS = 0x7FF0DEAD0000BEEF

#: the dummy slot: constant end time 0.0, the identity dependency
DUMMY_SLOT = 0

_INT32_MAX = 2 ** 31 - 1

#: the layout's arrays: (name, dtype, trailing shape)
_ARRAYS = (("out", torch.int32, ()), ("dep", torch.int32, (3,)),
           ("delay", torch.float64, (3,)), ("dur", torch.float64, ()),
           ("step", torch.int32, ()), ("walk_ptr", torch.int32, None),
           ("lane_walk_ptr", torch.int32, None))


@dataclasses.dataclass(frozen=True, eq=False)
class Walks:
    """A program's live rows grouped into walks: NumPy arrays on the
    host as :func:`build_walks` returns them, or tensors on one device
    after :meth:`to`.

    Row ``i`` writes slot ``out[i]`` from its three dependencies
    ``dep[i]`` with delays ``delay[i]`` and duration ``dur[i]``;
    ``step[i]`` is its step in its lane's program. The rows of walk
    ``w`` are ``walk_ptr[w]:walk_ptr[w + 1]``, in ascending step order;
    the walks of lane ``k`` are ``lane_walk_ptr[k]:lane_walk_ptr[k+1]``.
    ``max_walks`` is derived from ``lane_walk_ptr``, never given.
    """
    out: object             # (n,) int32
    dep: object             # (n, 3) int32
    delay: object           # (n, 3) float64
    dur: object             # (n,) float64
    step: object            # (n,) int32
    walk_ptr: object        # (walks + 1,) int32
    lane_walk_ptr: object   # (K + 1,) int32
    n_slots: int
    n_chains: int = 0       # chains found before folding
    seconds: float = 0.0    # host time the layout pass took
    max_walks: int = dataclasses.field(init=False)   # most walks a lane

    def __post_init__(self):
        p = self.lane_walk_ptr
        walks = p[1:] - p[:-1]
        object.__setattr__(self, "max_walks",
                           int(walks.max()) if len(walks) else 0)

    def arrays(self) -> tuple:
        return tuple(getattr(self, name) for name, _, _ in _ARRAYS)

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.arrays())

    def to(self, device) -> "Walks":
        """The layout as tensors on ``device``, as the scan takes it."""
        return dataclasses.replace(self, **{
            name: torch.as_tensor(getattr(self, name)).to(device)
            for name, _, _ in _ARRAYS})


def build_walks(out: np.ndarray, deps: Sequence[np.ndarray],
                delays: Sequence[Optional[np.ndarray]], dur: np.ndarray,
                lengths: np.ndarray, n_slots: int) -> Walks:
    """Group a ``(T, K)`` program's live rows (the first ``lengths[k]``
    steps of lane ``k``) into walks, from the program's arrays alone.

    Chains follow the ``dep0 == slot - 1`` links — in a compiled program
    one pipeline device's tasks in schedule order — and a lane's chains
    are folded onto :data:`MAX_WALKS` walks (chain ``c`` of a lane onto
    walk ``c % MAX_WALKS``). Each walk holds its rows in ascending step
    order, so a kernel that advances every walk in order cannot
    deadlock: the earliest unfinished row of a lane has its dependencies
    done and heads its walk. ``delays[d]`` may be ``None`` (all zeros).

    Raises unless every slot ``1 .. n_slots - 2`` is written by exactly
    one live row and every dependency is the dummy slot or a slot its
    own lane wrote at an earlier step — the two facts that make the
    walk scan well defined."""
    t0 = time.perf_counter()
    T, K = out.shape
    total = n_slots - 2
    if n_slots > _INT32_MAX:
        raise ValueError(
            f"n_slots = {n_slots} does not fit the int32 slot indices of "
            f"the walk layout (at most {_INT32_MAX})")
    lengths = np.minimum(np.asarray(lengths, dtype=np.int64), T)
    # live rows in memory (step-major) order: a sequential gather
    live = np.arange(T, dtype=np.int64)[:, None] < lengths[None, :]
    flat = np.flatnonzero(live)
    del live
    step, lane = np.divmod(flat, K) if K else (flat, flat)
    n = flat.size
    o = out.ravel()[flat].astype(np.int64)
    d = np.stack([p.ravel()[flat] for p in deps], axis=1).astype(np.int64)
    lay = np.zeros((n, 3))
    for i, p in enumerate(delays):
        if p is not None:
            lay[:, i] = p.ravel()[flat]
    du = np.ascontiguousarray(dur.ravel()[flat], dtype=np.float64)

    # every slot 1..total written exactly once
    if n != total or (n and (o.min() < 1 or o.max() > total)) or \
            np.bincount(o, minlength=n_slots)[1: total + 1].min(
                initial=1) != 1:
        raise ValueError(
            "walk layout: the live rows must write every slot 1 .. "
            f"n_slots - 2 exactly once ({n} live rows, {total} slots)")
    row_of = np.empty(n_slots, dtype=np.int64)
    row_of[o] = np.arange(n)
    lane_of = np.full(n_slots, -1, dtype=np.int64)
    lane_of[o] = lane
    step_of = np.zeros(n_slots, dtype=np.int64)
    step_of[o] = step
    dd = np.where((d >= 0) & (d < n_slots), d, total + 1)
    ok = (d == DUMMY_SLOT) | ((lane_of[dd] == lane[:, None])
                              & (step_of[dd] < step[:, None]))
    if not ok.all():
        r = int(np.argwhere(~ok)[0, 0])
        raise ValueError(
            f"walk layout: row at step {int(step[r])} of lane "
            f"{int(lane[r])} depends on {d[r].tolist()}; a dependency "
            "must be the dummy slot or a slot the same lane wrote at an "
            "earlier step")

    # chains: runs of slots linked by dep0 == slot - 1, in slot order
    by_slot = row_of[1: total + 1]
    slots = np.arange(1, total + 1)
    head = (d[by_slot, 0] != slots - 1) | (slots == 1)
    chain = np.empty(n, dtype=np.int64)
    chain[by_slot] = np.cumsum(head) - 1
    chain_lane = lane[by_slot[head]]
    n_chains = int(chain_lane.size)
    # a chain's rank among its lane's chains, folded onto the walks
    per_lane = np.bincount(chain_lane, minlength=K)
    first = np.concatenate([[0], np.cumsum(per_lane)[:-1]]).astype(np.int64)
    by_lane = np.argsort(chain_lane, kind="stable")
    rank = np.empty(n_chains, dtype=np.int64)
    rank[by_lane] = np.arange(n_chains) - first[chain_lane[by_lane]]
    walks = np.minimum(per_lane, MAX_WALKS)
    lane_walk_ptr = np.concatenate([[0], np.cumsum(walks)])
    gw = lane_walk_ptr[lane] + (rank % MAX_WALKS)[chain]
    # stable: rows are in step order, and stay so inside each walk
    order = np.argsort(gw, kind="stable")
    walk_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(gw, minlength=int(lane_walk_ptr[-1])))])

    def i32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    return Walks(
        out=i32(o[order]), dep=i32(d[order]),
        delay=np.ascontiguousarray(lay[order]), dur=du[order],
        step=i32(step[order]), walk_ptr=i32(walk_ptr),
        lane_walk_ptr=i32(lane_walk_ptr), n_slots=int(n_slots),
        n_chains=n_chains, seconds=time.perf_counter() - t0)


def _resolve(backend: str, t: torch.Tensor) -> str:
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"unknown scan backend {backend!r}; "
                         f"choose from {SCAN_BACKENDS}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "torch"
    if backend == "cuda" and not t.is_cuda:
        raise ValueError(
            "backend='cuda' needs tensors on a CUDA device; these "
            f"lie on {t.device} (use backend='torch' on the CPU)")
    return backend


def _check_walks(w: Walks) -> None:
    """Raise on a walk layout the implementations do not take."""
    if not all(isinstance(a, torch.Tensor) for a in w.arrays()):
        raise TypeError("the scan takes a layout of tensors: call "
                        "Walks.to(device) first")
    n = w.out.shape[0] if w.out.dim() == 1 else -1
    for name, dtype, tail in _ARRAYS:
        t = getattr(w, name)
        if tail is not None and tuple(t.shape) != (n,) + tail:
            raise ValueError(
                f"walks.{name} must have shape {(n,) + tail}; got "
                f"{tuple(t.shape)}")
        if tail is None and (t.dim() != 1 or t.numel() < 1):
            raise ValueError(f"walks.{name} must be a non-empty vector")
        if t.device != w.out.device:
            raise ValueError(
                f"walks.{name} lies on {t.device}, out on {w.out.device}")
        if not t.is_contiguous():
            raise ValueError(f"walks.{name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"walks.{name} must be {dtype}; got {t.dtype}")
    if w.max_walks > MAX_WALKS:
        raise ValueError(
            f"a lane has {w.max_walks} walks; the kernel takes at most "
            f"{MAX_WALKS} walks a lane")
    if not 2 <= w.n_slots <= _INT32_MAX:
        raise ValueError(f"n_slots must be in [2, {_INT32_MAX}]; got "
                         f"{w.n_slots}")


def scan_walks(w: Walks, backend: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a program in the walk layout (tensors on one device);
    returns float64 ``(ends, starts)`` tensors of length ``w.n_slots``
    on the layout's device, indexed by slot. The dummy slot 0 and the
    trash slot ``n_slots - 1`` read 0.0."""
    _check_walks(w)
    if _resolve(backend, w.out) == "cuda":
        return _scan_walks_cuda(w)
    return _scan_walks_torch(w)


def _scan_walks_torch(w: Walks):
    """Plain PyTorch version over the walk layout: the rows sorted by
    step, then per step one gather, add, row max and two index-puts
    over that step's rows (at most one a lane)."""
    dev = w.out.device
    ends = torch.zeros(w.n_slots, dtype=torch.float64, device=dev)
    starts = torch.zeros(w.n_slots, dtype=torch.float64, device=dev)
    if w.out.numel() == 0:
        return ends, starts
    order = torch.argsort(w.step, stable=True)
    bounds = [0] + torch.cumsum(torch.bincount(w.step.long()), 0).tolist()
    out, dep = w.out[order].long(), w.dep[order].long()
    delay, dur = w.delay[order], w.dur[order]
    for a, b in zip(bounds[:-1], bounds[1:]):
        start = (ends[dep[a:b]] + delay[a:b]).max(dim=-1).values
        starts[out[a:b]] = start
        ends[out[a:b]] = start + dur[a:b]
    return ends, starts


def _check(out, dep, delay, dur, n_slots, lengths) -> None:
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
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(
                f"{name} must be int32 or int64; got {t.dtype}")
    for name in ("delay", "dur"):
        t = want[name][0]
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64; got {t.dtype}")
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1; got {n_slots}")


def scan_steps(out: torch.Tensor, dep: torch.Tensor, delay: torch.Tensor,
               dur: torch.Tensor, n_slots: int,
               lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the step recurrence of ``(T, K)`` planes with the plain
    step loop; returns float64 ``(ends, starts)`` tensors of length
    ``n_slots`` on the inputs' device, indexed by slot
    (``starts[out[j, k]]`` is the start of step j of lane k).

    T steps, each a (K, 3) gather, an add, a row max and two
    index-puts. Lanes past their length rewrite the value their slot
    already holds, so shapes stay static (no device-to-host sync per
    step)."""
    _check(out, dep, delay, dur, n_slots, lengths)
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
        lib.megabatch_scan_launch.argtypes = [p] * 8 + [i, i, p]
        lib.megabatch_scan_launch.restype = i
        lib.megabatch_scan_smem_bytes.argtypes = [i]
        lib.megabatch_scan_smem_bytes.restype = i
        lib.megabatch_scan_error_string.argtypes = [i]
        lib.megabatch_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def threads_per_block(max_walks: int) -> int:
    """Threads of the kernel's blocks: one a walk, whole warps."""
    return max(32, -(-max_walks // 32) * 32)


def _scan_walks_cuda(w: Walks):
    """Wrapper of the CUDA kernel: checks its inputs, allocates the
    outputs, launches on the current stream and checks the launch. It
    does not synchronise: a fault inside the kernel (the watchdog's
    trap) surfaces at the next synchronising call as a RuntimeError.
    Each launch counts in ``k1.launches`` (:mod:`repro_torch.telemetry`)."""
    _check_walks(w)
    if not w.out.is_cuda:
        raise ValueError(
            f"the kernel needs tensors on a CUDA device; these lie on "
            f"{w.out.device}")
    dev, n_slots = w.out.device, w.n_slots
    starts = torch.zeros(n_slots, dtype=torch.float64, device=dev)
    K = w.lane_walk_ptr.numel() - 1
    if w.out.numel() == 0 or K == 0:
        return torch.zeros_like(starts), starts
    # every slot a row writes starts as the sentinel; the dummy and
    # trash slots hold 0.0 and are never written
    ends = torch.full((n_slots,), SENTINEL_BITS, dtype=torch.int64,
                      device=dev).view(torch.float64)
    ends[0] = 0.0
    ends[n_slots - 1] = 0.0
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.megabatch_scan_launch(
            w.out.data_ptr(), w.dep.data_ptr(), w.delay.data_ptr(),
            w.dur.data_ptr(), w.walk_ptr.data_ptr(),
            w.lane_walk_ptr.data_ptr(), ends.data_ptr(), starts.data_ptr(),
            K, threads_per_block(w.max_walks), stream)
    if err != 0:
        msg = lib.megabatch_scan_error_string(err).decode()
        raise RuntimeError(
            f"megabatch_scan kernel launch failed: {msg} (cudaError {err})")
    telemetry.count("k1.launches")
    return ends, starts
