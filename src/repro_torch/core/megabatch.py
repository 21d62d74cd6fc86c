"""Mega-batch predict: score many candidate engines in one array pass.

The paper's §6 use-case is bounded by how many strategies the model can
score per second. Per-candidate ``engine.run()`` pays a Python
scheduling loop per candidate; this module compiles the zero-noise
predict recurrence of K heterogeneous :class:`EventFlowEngine`s into
ONE padded ``(steps, K)`` array program and evaluates all candidates
simultaneously.

The key identity: along a candidate's :meth:`EventFlowEngine.topo_order`
every task's start time is

    start = max over deps of (end[dep] + delay)

with at most THREE dependencies — the previous task on the same device
(delay 0), the forward activation arrival (F producer at ``pos-1`` plus
``p2p_base[pos-1]``), and for B tasks the backward arrival (B producer
at ``pos+1`` plus ``p2p_base[pos]``). Step ``j`` of the program
evaluates the j-th topo task of EVERY candidate at once: each
candidate's topo order guarantees its deps landed at earlier steps, so
the per-step dependency pattern is a gather + add + row-max over a
``(K, 3)`` block. Candidates shorter than the longest one write their
padding steps into a per-program trash slot and read the constant
dummy slot (end = 0.0).

Bit-identity (the repo's standing bar for caching/parallelism work):
the NumPy backend performs exactly the FP operations of the per-engine
predict path — ``max`` is exact regardless of grouping, every addition
pairs the same operands (`end + p2p_base`, `start + dur`,
``free + ar_base + opt_base``), and the dummy slot's ``0.0 + 0.0``
contributions are absorbed exactly by the surrounding max over times
that are ≥ 0. Batch times are therefore bit-identical per candidate to
``engine.run().batch_time`` (asserted by the differential oracle in
``tests/test_search_engine.py``). Busy/bubble aggregates use array
segment sums whose FP summation order differs from the sequential
loop — they match to rounding, not to the bit, and are not gated.

Backends: ``numpy`` (the bit-identical host reference), ``torch`` (the
plain PyTorch loop over steps, on any device) and ``cuda`` (the
hand-written Hopper kernel); see
:mod:`repro_torch.kernels.megabatch_scan`. ``auto`` resolves to ``cuda``
when the program's device is a CUDA device and to ``torch`` when the
caller asked for the CPU. All three are float64 and bit-identical.

The ``cuda`` backend does not read the padded ``(T, K)`` planes. It
reads the program's *walk layout*
(:func:`repro_torch.kernels.megabatch_scan.build_walks`): the live rows
only, grouped per lane into walks — a pipeline device's chain of tasks
each, folded modulo ``MAX_WALKS`` — that the kernel advances in
parallel. The layout is built on the host once per :class:`MegaBatch`
and uploaded once; the ``torch`` backend uploads the planes instead.
Either stays on the device, so a repeat ``predict()`` pays only the
evaluation; the epilogue runs on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.engine import EventFlowEngine
# DUMMY_SLOT: global slot 0 — constant end time 0.0, the identity dependency
from repro_torch.kernels.megabatch_scan import (DUMMY_SLOT, Walks,
                                                build_walks, scan_steps,
                                                scan_walks)

BACKENDS = ("auto", "numpy", "torch", "cuda")

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class MegaPredict:
    """Per-candidate zero-noise predictions, one row per engine."""
    batch_times: np.ndarray        # (K,) — bit-identical to engine.run()
    bubble_fractions: np.ndarray   # (K,) — matches to rounding, not bits
    backend: str                   # backend that evaluated the recurrence
    n_candidates: int
    n_steps: int                   # padded program length (max task count)
    n_slots: int                   # global end-time vector length


def _flat(lists: Sequence[Sequence], dtype) -> np.ndarray:
    """Concatenate per-device task metadata lists into one flat array."""
    return np.concatenate(
        [np.asarray(lst, dtype=dtype) for lst in lists]) if lists else \
        np.zeros(0, dtype=dtype)


class MegaBatch:
    """Compiled array program over K candidate engines.

    Compile once (pure function of the engines' builds + schedules),
    then :meth:`predict` any number of times. Engines may be fully
    heterogeneous — different pp/microbatches/schedule/vpp — the
    program pads every candidate to the longest task count.

    ``device`` is where the accelerator backends evaluate the program
    (the card by default; the CPU only when the caller asks for it).
    Compilation itself is host-side NumPy.
    """

    def __init__(self, engines: Sequence[EventFlowEngine], perturb=None,
                 device=DEFAULT_DEVICE, verify=None):
        engines = list(engines)
        self.engines = engines
        self.device = resolve_device(device)
        self._planes = None            # device copies, made at first use
        self._walks = None             # host walk layout, built once
        self._device_walks = None
        # a Perturbation's straggler multipliers scale the profiled
        # means at compile time (same operand pairings as the engine's
        # speed plane, so candidate rows stay bit-identical to
        # engine.run(perturb=...)); perturb=None compiles byte-identical
        # arrays to the historical program. The single-replica program
        # requires effects uniform across DP (pipe_scale raises
        # otherwise); faults are run-level splices and rejected here.
        if perturb is not None and getattr(perturb, "faults", ()):
            raise ValueError(
                "mega-batch predict evaluates one step; fault recovery "
                "is spliced at the run level — use "
                "DistSim.simulate(perturb=...)")
        self.perturb = perturb
        K = len(engines)
        self.K = K
        sizes = [e.total_tasks for e in engines]
        self.T = max(sizes) if K else 0
        #: live steps per lane — rows past a lane's length are padding
        self._len = np.asarray(sizes, dtype=np.int64)
        total = int(sum(sizes))
        self.total = total
        # slot 0: dummy (end 0.0); slot total+1: trash for padding steps
        self.n_slots = total + 2
        trash = total + 1

        T, K = self.T, self.K
        self._out = np.full((T, K), trash, dtype=np.int64)
        # dep planes kept separate: the numpy hot loop runs ~T small
        # array steps, and three flat (K,) gathers beat one (K, 3)
        # gather + axis reduction. dep0 (device serialization) always
        # has delay 0, so it skips the add entirely — max() absorbs the
        # dropped `+ 0.0` exactly.
        self._dep0 = np.zeros((T, K), dtype=np.int64)
        self._dep1 = np.zeros((T, K), dtype=np.int64)
        self._dep2 = np.zeros((T, K), dtype=np.int64)
        self._del1 = np.zeros((T, K))
        self._del2 = np.zeros((T, K))
        self._dur = np.zeros((T, K))

        self._pp = np.asarray([e.strat.pp for e in engines], dtype=np.int64) \
            if K else np.zeros(0, dtype=np.int64)
        ppmax = int(self._pp.max()) if K else 0
        self.ppmax = ppmax
        # per-(candidate, pipeline-device) epilogue inputs, zero-padded
        self._free_slot = np.zeros((K, ppmax), dtype=np.int64)
        self._ar = np.zeros((K, ppmax))
        self._opt = np.zeros((K, ppmax))
        # per-task epilogue inputs, flat over all candidates' tasks
        self._seg = np.zeros(total, dtype=np.int64)   # k * ppmax + device
        self._send = np.full(total, -np.inf)          # boundary-send delay

        base = 1
        for k, eng in enumerate(engines):
            base = self._compile_one(k, eng, base, trash)

        # construction-time static verification of the compiled array
        # program (repro_torch.analyze): verify=None defers to
        # REPRO_VERIFY — on in tests/CI, off on the search hot path.
        from repro_torch.analyze.findings import default_verify
        if default_verify(verify):
            from repro_torch.analyze.findings import raise_on_findings
            from repro_torch.analyze.graph import verify_megabatch
            raise_on_findings(verify_megabatch(self))

    # ------------------------------------------------------------------

    def _compile_one(self, k: int, eng: EventFlowEngine, base: int,
                     trash: int) -> int:
        """Lower one engine's task recurrence into rows of the program.

        Slots ``base .. base+n`` hold this candidate's task end times in
        device-major schedule order; returns the next free slot."""
        pp, n_pos, m = eng.strat.pp, eng.n_pos, eng.m
        # deterministic straggler multiplier per pipeline device (None
        # when unperturbed — every array below then compiles
        # byte-identical to the historical program)
        scale = (self.perturb.pipe_scale(eng.strat)
                 if self.perturb is not None else None)
        n = eng.total_tasks
        n_per_dev = np.asarray([len(t) for t in eng.task_isf],
                               dtype=np.int64)
        dev_off = np.concatenate([[0], np.cumsum(n_per_dev)])
        if n == 0:
            return base

        isf = _flat(eng.task_isf, bool)
        pos = _flat(eng.task_pos, np.int64)
        mic = _flat(eng.task_micro, np.int64)
        dev = np.repeat(np.arange(pp, dtype=np.int64), n_per_dev)
        slots = base + np.arange(n, dtype=np.int64)

        fwd = np.asarray(eng.fwd_base)
        bwd = np.asarray(eng.bwd_base)
        p2p = np.asarray(eng.p2p_base)

        # producer lookup: global slot of the F / B task at (pos, micro)
        f_slot = np.zeros((n_pos, m), dtype=np.int64)
        b_slot = np.zeros((n_pos, m), dtype=np.int64)
        f_slot[pos[isf], mic[isf]] = slots[isf]
        b_slot[pos[~isf], mic[~isf]] = slots[~isf]

        # dep 0: previous task on the same device (device serialization)
        dep0 = slots - 1
        first = dev_off[:-1][n_per_dev > 0]
        dep0[first] = DUMMY_SLOT

        # dep 1: F tasks wait on the forward arrival from pos-1; B tasks
        # wait on their own position's F output (delay 0)
        dep1 = np.full(n, DUMMY_SLOT, dtype=np.int64)
        del1 = np.zeros(n)
        f_recv = isf & (pos > 0)
        dep1[f_recv] = f_slot[pos[f_recv] - 1, mic[f_recv]]
        del1[f_recv] = p2p[pos[f_recv] - 1]
        dep1[~isf] = f_slot[pos[~isf], mic[~isf]]

        # dep 2: B tasks below the last position also wait on the
        # backward arrival from pos+1
        dep2 = np.full(n, DUMMY_SLOT, dtype=np.int64)
        del2 = np.zeros(n)
        b_recv = (~isf) & (pos < n_pos - 1)
        dep2[b_recv] = b_slot[pos[b_recv] + 1, mic[b_recv]]
        del2[b_recv] = p2p[pos[b_recv]]

        dur = np.where(isf, fwd[pos], bwd[pos])

        # boundary sends: the send arrival extends the SENDING device's
        # pipeline-last time (run()'s p2p_ends bookkeeping)
        send = np.full(n, -np.inf)
        f_send = isf & (pos < n_pos - 1)
        send[f_send] = p2p[pos[f_send]]
        b_send = (~isf) & (pos > 0)
        send[b_send] = p2p[pos[b_send] - 1]

        if scale is not None:
            # every duration/delay is scaled by its EXECUTING device —
            # p2p by the sender (forward boundary p sends from device
            # p % pp, backward boundary p from (p+1) % pp) — the exact
            # products engine._sample forms via its speed plane
            dur = dur * scale[dev]
            del1[f_recv] = del1[f_recv] * scale[(pos[f_recv] - 1) % pp]
            del2[b_recv] = del2[b_recv] * scale[(pos[b_recv] + 1) % pp]
            send[f_send] = send[f_send] * scale[dev[f_send]]
            send[b_send] = send[b_send] * scale[dev[b_send]]

        if getattr(eng, "_decode", False):
            # decode: step t's stage 0 waits on step t-1's token
            # feedback from the last stage (dep1) and its arrival floor
            # (dep2 rides the dummy slot: 0.0 + arrival == arrival,
            # absorbed exactly by the row max — engine bit-identity).
            # The feedback p2p is sent by the LAST stage's device, so
            # it takes that device's straggler scale; arrival floors
            # are wall-clock and never scale.
            fb_base = eng.fb_base
            if scale is not None:
                fb_base = fb_base * scale[(n_pos - 1) % pp]
            f0 = isf & (pos == 0)
            later = f0 & (mic > 0)
            dep1[later] = f_slot[n_pos - 1, mic[later] - 1]
            del1[later] = fb_base
            arrival = np.asarray(eng.arrival)
            del2[f0] = arrival[mic[f0]]
            fb_send = isf & (pos == n_pos - 1)
            send[fb_send] = fb_base

        # reorder rows along this candidate's topo order: step j of the
        # program evaluates its j-th ready task
        topo = np.asarray(eng.topo_order(), dtype=np.int64)    # (n, 2)
        perm = dev_off[topo[:, 0]] + topo[:, 1]
        self._out[:n, k] = slots[perm]
        self._dep0[:n, k] = dep0[perm]
        self._dep1[:n, k] = dep1[perm]
        self._dep2[:n, k] = dep2[perm]
        self._del1[:n, k] = del1[perm]
        self._del2[:n, k] = del2[perm]
        self._dur[:n, k] = dur[perm]

        # epilogue: device free slots (last task per device, in schedule
        # order), segment ids, send delays, DP-sync + optimizer means
        last_local = dev_off[1:] - 1
        free = np.where(n_per_dev > 0, slots[last_local], DUMMY_SLOT)
        self._free_slot[k, :pp] = free
        self._seg[base - 1: base - 1 + n] = k * self.ppmax + dev
        self._send[base - 1: base - 1 + n] = send
        if scale is None:
            self._ar[k, :pp] = eng.ar_base   # zeros when engine no-sync
            self._opt[k, :pp] = eng.opt_base
        else:
            self._ar[k, :pp] = np.asarray(eng.ar_base) * scale
            self._opt[k, :pp] = np.asarray(eng.opt_base) * scale
        return base + n

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def resolve_backend(self, backend: str = "auto") -> str:
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown megabatch backend {backend!r}; "
                f"choose from {BACKENDS}")
        if backend != "auto":
            return backend
        return "cuda" if self.device.type == "cuda" else "torch"

    def _eval_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """Reference evaluation: T steps, each three (K,) gathers, two
        adds and a 3-way max. Exactly the per-engine predict FP
        operations (dep0's delay is 0 by construction and skipped —
        ``max(x, ...)`` vs ``max(x + 0.0, ...)`` is the same bit)."""
        ends = np.zeros(self.n_slots)
        starts = np.zeros(self.n_slots)
        out = self._out
        d0, d1, d2 = self._dep0, self._dep1, self._dep2
        l1, l2, dur = self._del1, self._del2, self._dur
        mx = np.maximum
        for j in range(self.T):
            s = mx(mx(ends[d0[j]], ends[d1[j]] + l1[j]),
                   ends[d2[j]] + l2[j])
            o = out[j]
            starts[o] = s
            ends[o] = s + dur[j]
        return ends, starts

    def _stacked(self) -> Tuple[np.ndarray, np.ndarray]:
        """(T, K, 3) dep/delay stacks — the accelerator-backend layout."""
        dep = np.stack([self._dep0, self._dep1, self._dep2], axis=-1)
        delay = np.stack([np.zeros_like(self._del1), self._del1,
                          self._del2], axis=-1)
        return dep, delay

    def device_planes(self) -> dict:
        """The program on :attr:`device` in the accelerator layout
        (:meth:`_stacked`, slot indices narrowed to int32), uploaded at
        the first call and kept: ``out (T,K)``, ``dep (T,K,3)``,
        ``delay (T,K,3)``, ``dur (T,K)``, ``lengths (K,)``. Planes are
        copied one at a time so the host never holds the stacked
        program beside the flat one."""
        if self._planes is not None:
            return self._planes
        if self.n_slots > _INT32_MAX:
            raise ValueError(
                f"n_slots = {self.n_slots} does not fit the int32 slot "
                f"indices of the device program (at most {_INT32_MAX})")
        T, K, dev = self.T, self.K, self.device

        def up(a: np.ndarray, dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        dep = torch.empty((T, K, 3), dtype=torch.int32, device=dev)
        delay = torch.zeros((T, K, 3), dtype=torch.float64, device=dev)
        for d, plane in enumerate((self._dep0, self._dep1, self._dep2)):
            dep[:, :, d] = up(plane, torch.int32)
        for d, plane in ((1, self._del1), (2, self._del2)):
            delay[:, :, d] = up(plane, torch.float64)
        self._planes = {
            "out": up(self._out, torch.int32), "dep": dep, "delay": delay,
            "dur": up(self._dur, torch.float64),
            "lengths": up(self._len, torch.int32)}
        return self._planes

    def walk_layout(self) -> Walks:
        """The program's walk layout (:func:`build_walks`), built on the
        host at the first call and kept; its ``seconds`` say what the
        pass cost."""
        if self._walks is None:
            self._walks = build_walks(
                self._out, (self._dep0, self._dep1, self._dep2),
                (None, self._del1, self._del2), self._dur, self._len,
                self.n_slots)
        return self._walks

    def device_walks(self) -> Walks:
        """The walk layout on :attr:`device`, uploaded at the first call
        and kept — what the ``cuda`` backend evaluates."""
        if self._device_walks is None:
            self._device_walks = self.walk_layout().to(self.device)
        return self._device_walks

    def device_bytes(self) -> int:
        """Bytes the uploaded program holds on the device: the walk
        layout for the ``cuda`` backend, the planes for ``torch`` (0
        before the first accelerator evaluation)."""
        planes = sum(t.nbytes for t in self._planes.values()) \
            if self._planes else 0
        walks = self._device_walks.nbytes \
            if self._device_walks is not None else 0
        return planes + walks

    def _eval(self, backend: str) -> Tuple[np.ndarray, np.ndarray, str]:
        backend = self.resolve_backend(backend)
        if backend == "numpy" or self.K == 0:
            ends, starts = self._eval_numpy()
            return ends, starts, "numpy"
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend='cuda' needs a program on a CUDA device; this "
                f"one was built for {self.device}")
        if backend == "cuda":
            ends, starts = scan_walks(self.device_walks(), backend="cuda")
        else:
            p = self.device_planes()
            ends, starts = scan_steps(
                p["out"], p["dep"], p["delay"], p["dur"], self.n_slots,
                lengths=p["lengths"])
        # the copy to the host waits for the kernel on the current stream
        return ends.cpu().numpy(), starts.cpu().numpy(), backend

    def predict_times(self, backend: str = "auto") -> np.ndarray:
        """(K,) predicted batch times — ``engine.run().batch_time`` per
        candidate, bit-identical on the numpy backend."""
        return self.predict(backend).batch_times

    def predict(self, backend: str = "auto") -> MegaPredict:
        if self.K == 0:
            return MegaPredict(np.zeros(0), np.zeros(0), "numpy", 0,
                               self.T, self.n_slots)
        ends, starts, used = self._eval(backend)
        K, ppmax, total = self.K, self.ppmax, self.total
        task_end = ends[1: total + 1]
        task_start = starts[1: total + 1]

        # pipeline-last per (candidate, device): task ends and boundary
        # send arrivals, segment-maxed (run()'s pipe_last fold)
        last_pipe = np.zeros(K * ppmax)
        np.maximum.at(last_pipe, self._seg, task_end)
        np.maximum.at(last_pipe, self._seg, task_end + self._send)
        last_pipe = last_pipe.reshape(K, ppmax)

        # DP sync + optimizer epilogue. Non-sync engines carry ar == 0,
        # so `free + 0.0` reproduces their `t0 = free` path exactly.
        free = ends[self._free_slot]
        opt_t1 = (free + self._ar) + self._opt
        last = np.maximum(last_pipe, opt_t1)
        batch_times = np.maximum(last.max(axis=1), 0.0)

        # busy / bubble (not bit-gated: segment-sum order differs from
        # the sequential accumulation)
        busy = np.zeros(K * ppmax)
        np.add.at(busy, self._seg, task_end - task_start)
        busy = busy.reshape(K, ppmax) + self._ar + self._opt
        with np.errstate(invalid="ignore", divide="ignore"):
            util = np.where(batch_times[:, None] > 0,
                            busy / batch_times[:, None], 0.0)
        mean_util = util.sum(axis=1) / self._pp
        bubble = 1.0 - mean_util
        return MegaPredict(batch_times, bubble, used, K, self.T,
                           self.n_slots)


def megabatch_predict(engines: Sequence[EventFlowEngine],
                      backend: str = "auto", perturb=None,
                      device=DEFAULT_DEVICE) -> MegaPredict:
    """One-shot convenience: compile + evaluate K engines on ``device``,
    optionally under a :class:`repro_torch.core.perturb.Perturbation`
    straggler plane (uniform across DP; each candidate row stays
    bit-identical to ``engine.run(perturb=perturb)``)."""
    return MegaBatch(engines, perturb=perturb,
                     device=device).predict(backend)


#: arrays of a compiled program, as :func:`program_from_arrays` takes them
PROGRAM_ARRAYS = ("_out", "_dep0", "_dep1", "_dep2", "_del1", "_del2",
                  "_dur", "_pp", "_free_slot", "_ar", "_opt", "_seg",
                  "_send")


def program_from_arrays(arrays: dict, device=DEFAULT_DEVICE) -> MegaBatch:
    """A :class:`MegaBatch` over an already-compiled program.

    ``arrays`` maps the names of :data:`PROGRAM_ARRAYS` to NumPy arrays
    plus ``total`` and ``n_slots`` as ints — the attributes a compiled
    ``MegaBatch`` holds (of this package or of the reference one, which
    lets one program be pushed through both). The result has no engines
    and evaluates exactly like the program it was copied from."""
    mb = object.__new__(MegaBatch)
    mb.engines = []
    mb.perturb = None
    mb.device = resolve_device(device)
    mb._planes = None
    mb._walks = None
    mb._device_walks = None
    dtypes = {"_del1": np.float64, "_del2": np.float64, "_dur": np.float64,
              "_ar": np.float64, "_opt": np.float64, "_send": np.float64}
    for name in PROGRAM_ARRAYS:
        setattr(mb, name, np.ascontiguousarray(
            arrays[name], dtype=dtypes.get(name, np.int64)))
    mb.T, mb.K = mb._out.shape
    mb.total = int(arrays["total"])
    mb.n_slots = int(arrays["n_slots"])
    if mb.n_slots != mb.total + 2:
        raise ValueError(
            f"n_slots must be total + 2 (dummy and trash slots); got "
            f"n_slots={mb.n_slots}, total={mb.total}")
    mb.ppmax = mb._free_slot.shape[1] if mb.K else 0
    # live rows form a prefix of each lane; padding writes the trash slot
    mb._len = (mb._out != mb.total + 1).sum(axis=0).astype(np.int64)
    return mb
