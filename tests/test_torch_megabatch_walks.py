"""The walk layout of the mega-batch program and the scans over it.

``build_walks`` groups a compiled program's live rows into walks (one
pipeline device's chain of tasks each, folded modulo ``MAX_WALKS``); the
CUDA kernel advances the walks of a lane in parallel, and its plain
version evaluates the same layout in step order. On the CPU these tests
hold the layout's invariants, the plain walk version and a pure-Python
emulation of the kernel's dataflow schedule against the port's numpy
evaluation, the reference package's numpy evaluation and the reference
TPU kernel in interpret mode (in float64), on the port's compiled
programs, on ``program_from_arrays`` copies of the reference's, and on
random programs — some with more chains a lane than ``MAX_WALKS``, so
that folding happens. Bar: bit-identity (``np.array_equal``, 0 ulp); the
arithmetic is ``+`` and ``max`` on doubles. The kernel itself is held
against the plain version on the card (the ``gpu`` test here and
``chip_smoke.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs.base as ref_configs
import repro.core as ref
import repro_torch.configs.base as port_configs
import repro_torch.core as port
from repro.kernels import megabatch_scan as ref_scan
from repro_torch.core import scenario as port_scn
from repro_torch.core.megabatch import (PROGRAM_ARRAYS, MegaBatch,
                                        program_from_arrays)
from repro_torch.kernels import megabatch_scan as scan
from repro_torch.kernels.megabatch_scan import build_walks
from repro_torch.telemetry import COUNTS

CAP = scan.MAX_WALKS

STRAT_KW = [
    dict(mp=1, pp=1, dp=1, microbatches=1),
    dict(mp=1, pp=2, dp=2, microbatches=4),
    dict(mp=1, pp=4, dp=1, microbatches=8, schedule="gpipe"),
    dict(mp=2, pp=2, dp=1, microbatches=4, schedule="interleaved", vpp=2),
    dict(mp=1, pp=2, dp=2, microbatches=4, schedule="pipedream"),
    dict(mp=2, pp=2, dp=2, microbatches=4, zero1=True),
    dict(mp=1, pp=4, dp=2, microbatches=16, schedule="interleaved", vpp=3),
    dict(mp=1, pp=2, dp=2, microbatches=4, grad_compress=0.25),
    dict(mp=1, pp=8, dp=1, microbatches=8),
]
GPIPE_KW = [dict(mp=1, pp=p, dp=1, microbatches=m, schedule="gpipe")
            for p, m in ((2, 2), (4, 8), (8, 16))]
EMPTY_STAGE_KW = [dict(pp=4, microbatches=4), dict(pp=2, microbatches=2),
                  dict(pp=8, microbatches=8, schedule="gpipe")]
DECODE = dict(steps=3, arrivals=(0.0, 1e-4, 2e-4))

# (strategies, smoke config, seq, decode scenario)
PROGRAMS = {
    "ragged-1f1b-mix": (STRAT_KW, False, 128, False),
    "gpipe": (GPIPE_KW, False, 128, False),
    "empty-stage": (EMPTY_STAGE_KW, True, 64, False),
    "decode": (STRAT_KW[:3], False, 128, True),
}


def engines_of(pkg, configs, kws, smoke=False, seq=128, decode=False):
    cfg = configs.get_config("gpt2_345m")
    if smoke:
        cfg = configs.smoke_config(cfg)
    provider = pkg.AnalyticalProvider(pkg.A40_CLUSTER)
    out = []
    for kw in kws:
        s = pkg.Strategy(**kw)
        sim = pkg.DistSim(cfg, s, s.dp * s.microbatches * 2, seq, provider)
        if decode:
            scn = (port_scn if pkg is port else ref_scenario()).Decode(
                **DECODE)
            out.append(sim.engine(scenario=scn))
        else:
            out.append(sim.engine())
    return out


def ref_scenario():
    from repro.core import scenario
    return scenario


def port_program(name):
    kws, smoke, seq, decode = PROGRAMS[name]
    return MegaBatch(engines_of(port, port_configs, kws, smoke, seq, decode),
                     device="cpu")


def ref_program(name):
    kws, smoke, seq, decode = PROGRAMS[name]
    return ref.MegaBatch(engines_of(ref, ref_configs, kws, smoke, seq,
                                    decode))


def copy_of(r):
    arrays = {n: getattr(r, n) for n in PROGRAM_ARRAYS}
    arrays.update(total=r.total, n_slots=r.n_slots)
    return program_from_arrays(arrays, device="cpu")


def layout_of(prog):
    return build_walks(prog._out, (prog._dep0, prog._dep1, prog._dep2),
                       (None, prog._del1, prog._del2), prog._dur,
                       prog._len, prog.n_slots)


def walk_lanes(layout):
    """(lane of each walk, walk of each row)."""
    walks = np.diff(layout.lane_walk_ptr)
    lane = np.repeat(np.arange(walks.size), walks)
    row_walk = np.repeat(np.arange(lane.size), np.diff(layout.walk_ptr))
    return lane, row_walk


def assert_layout(prog, layout):
    """The invariants the kernel relies on, and the rows being the
    program's own."""
    total = prog.total
    assert layout.n_slots == prog.n_slots
    assert np.array_equal(np.sort(layout.out), np.arange(1, total + 1))
    assert layout.walk_ptr[0] == 0 and layout.walk_ptr[-1] == total
    walks = np.diff(layout.lane_walk_ptr)
    assert walks.size == prog.K
    assert walks.max(initial=0) == layout.max_walks <= CAP
    assert np.all(np.diff(layout.walk_ptr) > 0)          # no empty walk
    lane, row_walk = walk_lanes(layout)
    row_lane = lane[row_walk]
    # ascending step order inside every walk
    same = row_walk[1:] == row_walk[:-1]
    assert np.all(np.diff(layout.step.astype(np.int64))[same] > 0)
    # each row is the program's row at (step, lane)
    st = layout.step.astype(np.int64)
    assert np.all(st < prog._len[row_lane])
    assert np.array_equal(layout.out, prog._out[st, row_lane])
    for d, plane in enumerate((prog._dep0, prog._dep1, prog._dep2)):
        assert np.array_equal(layout.dep[:, d], plane[st, row_lane])
    assert np.array_equal(layout.delay[:, 0], np.zeros(total))
    assert np.array_equal(layout.delay[:, 1], prog._del1[st, row_lane])
    assert np.array_equal(layout.delay[:, 2], prog._del2[st, row_lane])
    assert np.array_equal(layout.dur, prog._dur[st, row_lane])
    for a in (layout.out, layout.dep, layout.step, layout.walk_ptr,
              layout.lane_walk_ptr):
        assert a.dtype == np.int32 and a.flags.c_contiguous


def assert_one_walk_per_device(engines, layout):
    """pp <= MAX_WALKS: one walk per pipeline device that owns tasks,
    holding exactly that device's tasks."""
    walks = np.diff(layout.lane_walk_ptr)
    lane, row_walk = walk_lanes(layout)
    base = 1
    for k, eng in enumerate(engines):
        sizes = [len(t) for t in eng.task_isf]
        assert eng.strat.pp <= CAP
        assert walks[k] == sum(n > 0 for n in sizes)
        # the device of each slot, in the compiler's device-major order
        dev_of = np.repeat(np.arange(len(sizes)), sizes)
        rows = np.flatnonzero(lane[row_walk] == k)
        devs = dev_of[layout.out[rows] - base]
        for w in np.unique(row_walk[rows]):
            assert len(set(devs[row_walk[rows] == w].tolist())) == 1
        base += eng.total_tasks


def plain_walks(layout):
    ends, starts = scan.scan_walks(layout.to("cpu"), backend="auto")
    return ends.numpy(), starts.numpy()


def emulate(layout):
    """Pure-Python emulation of the kernel's schedule: ``ends`` starts
    as the sentinel in every written slot; passes run over all walks
    round-robin, each walk advancing its head row once if no dependency
    still holds the sentinel (its own previous row's end comes from a
    register, the dummy slot reads 0.0). A pass's stores become visible
    to the other walks at the next pass, as a store reaches a reader one
    round trip later. Raises on a pass in which no walk moves. Returns
    ``(ends, starts, passes)``."""
    sentinel = np.array([scan.SENTINEL_BITS]).view(np.float64)[0]
    n_slots = layout.n_slots
    ends = np.full(n_slots, sentinel)
    ends[0] = ends[n_slots - 1] = 0.0
    starts = np.zeros(n_slots)
    heads = layout.walk_ptr[:-1].astype(np.int64)
    stops = layout.walk_ptr[1:].astype(np.int64)
    prev_out = np.full(heads.size, -1)
    prev_end = np.zeros(heads.size)

    def held(v):
        return np.float64(v).view(np.int64) == scan.SENTINEL_BITS

    passes = 0
    while np.any(heads < stops):
        passes += 1
        stores = []
        for w in np.flatnonzero(heads < stops):
            r = heads[w]
            vals = []
            for d in layout.dep[r]:
                if d == prev_out[w]:
                    vals.append(prev_end[w])
                elif d == 0:
                    vals.append(0.0)
                else:
                    vals.append(ends[d])
            if any(held(v) for v in vals):
                continue
            l0, l1, l2 = layout.delay[r]
            s = max(max(vals[0] + l0, vals[1] + l1), vals[2] + l2)
            o = layout.out[r]
            starts[o] = s
            stores.append((o, s + layout.dur[r]))
            prev_out[w], prev_end[w] = o, stores[-1][1]
            heads[w] += 1
        if not stores:
            raise AssertionError(f"the schedule stalled at pass {passes}")
        for o, e in stores:
            ends[o] = e
    return ends, starts, passes


def assert_same_bits(prog, ends, starts, ref_eval=None):
    want_ends, want_starts = (ref_eval or prog._eval_numpy)()
    t = prog.total
    assert np.array_equal(ends, want_ends)
    assert np.array_equal(starts[1: t + 1], want_starts[1: t + 1])


# --------------------------------------------------------------------------
# random programs
# --------------------------------------------------------------------------

class RandomProgram:
    """A random valid program in the compiler's layout (slot 0 the
    dummy, one contiguous slot range a lane in shuffled step order,
    dependencies on the dummy or on slots the same lane wrote earlier):
    its chains are mostly single rows, so a lane longer than
    ``MAX_WALKS`` rows folds many chains onto each walk."""

    def __init__(self, seed: int, K: int, max_len: int):
        rng = np.random.default_rng(seed)
        lens = rng.integers(1, max_len + 1, size=K)
        lens[rng.integers(K)] = max_len
        self._setup(lens)
        base = 1
        for k, n in enumerate(int(n) for n in lens):
            slots = base + rng.permutation(n)
            self._out[:n, k] = slots
            for j in range(1, n):
                for d in self._deps:
                    if rng.random() < 0.7:
                        d[j, k] = slots[rng.integers(j)]
            self._fill_times(rng, k, n)
            base += n

    def _setup(self, lens):
        self.T, self.K = int(lens.max()), int(lens.size)
        self.total = int(lens.sum())
        self.n_slots = self.total + 2
        self._len = lens.astype(np.int64)
        self._out = np.full((self.T, self.K), self.total + 1,
                            dtype=np.int64)
        self._deps = [np.zeros((self.T, self.K), dtype=np.int64)
                      for _ in range(3)]
        self._dep0, self._dep1, self._dep2 = self._deps
        self._del1 = np.zeros((self.T, self.K))
        self._del2 = np.zeros((self.T, self.K))
        self._dur = np.zeros((self.T, self.K))

    def _fill_times(self, rng, k, n):
        self._del1[:n, k] = rng.random(n) * 1e-3
        self._del2[:n, k] = rng.random(n) * 1e-3
        self._dur[:n, k] = rng.random(n) * 1e-2

    _eval_numpy = MegaBatch._eval_numpy


class ChainedProgram(RandomProgram):
    """Lanes of P chains ("devices") of L rows each, P drawn past
    ``MAX_WALKS`` so that chains fold, laid out as the compiler lays a
    pipeline out: a chain's slots contiguous with dep0 the previous
    slot, rows in round-robin step order (row i of chain c at step
    i·P + c), dep1 a row of chain c-1 (forward) and dep2 an earlier row
    of chain c+1 (backward), so walks depend on each other in both
    directions."""

    def __init__(self, seed: int, K: int, chains: tuple, length: tuple):
        rng = np.random.default_rng(seed)
        P = rng.integers(chains[0], chains[1] + 1, size=K)
        L = rng.integers(length[0], length[1] + 1, size=K)
        self.chains = P
        self._setup(P * L)
        base = 1
        for k in range(K):
            p, ln = int(P[k]), int(L[k])
            c, i = np.divmod(np.arange(p * ln), ln)       # slot order
            slot = base + c * ln + i
            step = i * p + c
            self._out[step, k] = slot
            self._dep0[step, k] = np.where(i > 0, slot - 1, 0)
            back = rng.integers(0, 3, size=slot.size)
            fwd_i = np.maximum(i - back, 0)
            use = (c > 0) & (rng.random(slot.size) < 0.8)
            self._dep1[step, k] = np.where(use, base + (c - 1) * ln + fwd_i,
                                           0)
            bwd_i = i - 1 - rng.integers(0, 3, size=slot.size)
            use = (c < p - 1) & (bwd_i >= 0) & (rng.random(slot.size) < 0.8)
            self._dep2[step, k] = np.where(use, base + (c + 1) * ln + bwd_i,
                                           0)
            self._fill_times(rng, k, p * ln)
            base += p * ln


RANDOM = {
    "one-row": lambda: RandomProgram(0, 1, 1),
    "short": lambda: RandomProgram(1, 3, 17),
    "folded": lambda: RandomProgram(3, 5, 200),
    "chains-below-cap": lambda: ChainedProgram(4, 3, (2, 40), (1, 9)),
    "chains-past-cap": lambda: ChainedProgram(5, 4, (65, 150), (2, 8)),
}


# --------------------------------------------------------------------------
# the layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_layout_of_compiled_programs(name):
    mb = port_program(name)
    layout = mb.walk_layout()
    assert mb.walk_layout() is layout                  # built once
    assert layout.seconds >= 0.0
    assert_layout(mb, layout)
    assert_one_walk_per_device(mb.engines, layout)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_layout_of_reference_programs_via_arrays(name):
    r = ref_program(name)
    p = copy_of(r)
    layout = p.walk_layout()
    assert_layout(p, layout)
    assert_one_walk_per_device(r.engines, layout)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_layout_of_random_programs(name):
    prog = RANDOM[name]()
    layout = layout_of(prog)
    assert_layout(prog, layout)
    if isinstance(prog, ChainedProgram):
        assert layout.n_chains == int(prog.chains.sum())
        assert layout.max_walks == min(int(prog.chains.max()), CAP)
        assert np.array_equal(np.diff(layout.lane_walk_ptr),
                              np.minimum(prog.chains, CAP))
    if name.endswith("past-cap") or name == "folded":
        assert layout.n_chains > layout.walk_ptr.size - 1    # folding


def test_layout_refuses_a_slot_written_twice():
    prog = RandomProgram(6, 2, 9)
    prog._out[1, 0] = prog._out[0, 0]
    with pytest.raises(ValueError, match="exactly once"):
        layout_of(prog)


@pytest.mark.parametrize("bad", ["later-step", "other-lane", "trash",
                                 "out-of-range"])
def test_layout_refuses_a_dependency_the_kernel_could_wait_on_forever(bad):
    prog = RandomProgram(7, 2, 12)
    n0 = int(prog._len[0])
    target = {"later-step": prog._out[n0 - 1, 0],
              "other-lane": prog._out[0, 1],
              "trash": prog.total + 1,
              "out-of-range": prog.n_slots + 5}[bad]
    prog._dep1[0, 0] = target
    with pytest.raises(ValueError, match="dummy slot"):
        layout_of(prog)


# --------------------------------------------------------------------------
# the plain walk version and the schedule, against the references
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plain_walks_bit_identical_on_compiled_programs(name):
    mb = port_program(name)
    ends, starts = plain_walks(mb.walk_layout())
    assert_same_bits(mb, ends, starts)
    emu_ends, emu_starts, _ = emulate(mb.walk_layout())
    assert_same_bits(mb, emu_ends, emu_starts)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plain_walks_bit_identical_to_the_reference_package(name):
    """A reference program copied over: the plain walk version and the
    emulated schedule against the reference's numpy evaluation and its
    TPU kernel in interpret mode, run in float64."""
    r = ref_program(name)
    p = copy_of(r)
    layout = p.walk_layout()
    ends, starts = plain_walks(layout)
    assert_same_bits(p, ends, starts, r._eval_numpy)
    emu_ends, emu_starts, _ = emulate(layout)
    assert_same_bits(p, emu_ends, emu_starts, r._eval_numpy)
    dep, delay = r._stacked()
    with jax.enable_x64(True):
        pl_ends, pl_starts = ref_scan.scan_steps(
            r._out, dep, delay, r._dur, r.n_slots, backend="pallas",
            interpret=True)
    t = r.total
    assert np.array_equal(ends[1: t + 1], pl_ends[1: t + 1])
    assert np.array_equal(starts[1: t + 1], pl_starts[1: t + 1])


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_plain_walks_and_schedule_bit_identical_on_random_programs(name):
    prog = RANDOM[name]()
    layout = layout_of(prog)
    ends, starts = plain_walks(layout)
    assert_same_bits(prog, ends, starts)
    assert_same_bits(prog, ends, starts,
                     lambda: ref.MegaBatch._eval_numpy(prog))
    emu_ends, emu_starts, passes = emulate(layout)
    assert_same_bits(prog, emu_ends, emu_starts)
    # the trash and dummy slots stay 0.0
    assert ends[0] == ends[-1] == emu_ends[0] == emu_ends[-1] == 0.0
    assert passes >= int(np.diff(layout.walk_ptr).max())


def test_schedule_takes_about_the_dag_depth_when_nothing_folds():
    """Below the cap every chain has its own walk, so the emulated
    passes are exactly the DAG's depth (the longest dependency path, in
    rows), far below the longest lane's row count."""
    prog = ChainedProgram(8, 2, (20, 30), (30, 40))
    layout = layout_of(prog)
    _, _, passes = emulate(layout)
    level = np.zeros(prog.n_slots, dtype=np.int64)
    for j in range(prog.T):
        live = j < prog._len
        lv = 1 + np.maximum(np.maximum(level[prog._dep0[j]],
                                       level[prog._dep1[j]]),
                            level[prog._dep2[j]])
        level[prog._out[j][live]] = lv[live]
    depth = int(level[1: prog.total + 1].max())
    assert passes == depth
    assert passes < int(prog._len.max()) // 4


# --------------------------------------------------------------------------
# MegaBatch and the wrapper
# --------------------------------------------------------------------------

def test_megabatch_uploads_the_walk_layout_once():
    mb = port_program("ragged-1f1b-mix")
    assert mb.device_bytes() == 0
    w = mb.device_walks()
    assert mb.device_walks() is w
    layout = mb.walk_layout()
    n = mb.total
    assert mb.device_bytes() == w.nbytes == layout.nbytes \
        == n * (4 + 12 + 24 + 8 + 4) \
        + 4 * (layout.walk_ptr.size + layout.lane_walk_ptr.size)
    assert w.max_walks == layout.max_walks == 8
    mb.predict("torch")                  # the planes join the walks
    assert mb.device_bytes() > n * 52


def test_scan_walks_refuses_cpu_tensors_for_the_kernel():
    layout = layout_of(RandomProgram(9, 3, 9))
    before = COUNTS.get("k1.launches", 0)
    with pytest.raises(ValueError, match="CUDA device"):
        scan.scan_walks(layout.to("cpu"), backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        scan._scan_walks_cuda(layout.to("cpu"))
    assert COUNTS.get("k1.launches", 0) == before


def test_scan_walks_checks_its_inputs():
    layout = layout_of(RandomProgram(10, 3, 9))
    w = layout.to("cpu")
    with pytest.raises(TypeError, match="int32"):
        scan.scan_walks(dataclasses.replace(w, out=w.out.long()))
    with pytest.raises(TypeError, match="float64"):
        scan.scan_walks(dataclasses.replace(w, dur=w.dur.float()))
    with pytest.raises(ValueError, match="shape"):
        scan.scan_walks(dataclasses.replace(
            w, delay=w.delay[:, :2].contiguous()))
    with pytest.raises(ValueError, match="backend"):
        scan.scan_walks(w, backend="pallas")
    with pytest.raises(TypeError, match="Walks.to"):
        scan.scan_walks(layout)                  # NumPy arrays, no device


def test_max_walks_is_derived_from_the_layout():
    """The kernel's block size comes from ``max_walks``, so it cannot be
    given: it always follows ``lane_walk_ptr``, on the host and on the
    device, and a lane with more walks than the kernel has threads is
    refused before any launch."""
    layout = layout_of(ChainedProgram(11, 4, (30, 40), (1, 4)))
    assert layout.max_walks == int(np.diff(layout.lane_walk_ptr).max())
    w = layout.to("cpu")
    assert w.max_walks == layout.max_walks
    with pytest.raises(TypeError):
        scan.Walks(*layout.arrays(), n_slots=layout.n_slots, max_walks=1)
    walks = int(layout.walk_ptr.size - 1)
    one_lane = dataclasses.replace(
        w, lane_walk_ptr=torch.tensor([0, walks], dtype=torch.int32))
    assert one_lane.max_walks == walks > CAP
    before = COUNTS.get("k1.launches", 0)
    for call in (scan.scan_walks, scan._scan_walks_cuda):
        with pytest.raises(ValueError, match="at most"):
            call(one_lane)
    assert COUNTS.get("k1.launches", 0) == before


@pytest.mark.parametrize("max_walks,threads", [(0, 32), (1, 32), (32, 32),
                                               (33, 64), (64, 64)])
def test_threads_per_block(max_walks, threads):
    assert scan.threads_per_block(max_walks) == threads


@pytest.mark.gpu
def test_kernel_bit_identical_on_the_card():
    """Needs a CUDA device and nvcc: the walk kernel against the plain
    walk version and numpy on random and chained programs, and
    ``MegaBatch``'s cuda backend against numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for name, make in sorted(RANDOM.items()):
        prog = make()
        w = layout_of(prog).to("cuda")
        before = COUNTS.get("k1.launches", 0)
        ek, sk = scan.scan_walks(w, backend="cuda")
        torch.cuda.synchronize()
        assert COUNTS.get("k1.launches", 0) == before + 1, name
        ep, sp = scan.scan_walks(w, backend="torch")
        assert torch.equal(ek, ep) and torch.equal(sk, sp), name
        assert_same_bits(prog, ek.cpu().numpy(), sk.cpu().numpy())
    mb = MegaBatch(engines_of(port, port_configs, STRAT_KW), device="cuda")
    assert np.array_equal(mb.predict("cuda").batch_times,
                          mb.predict("numpy").batch_times)


# a lane of two walks that wait on each other: row 0 (walk 0, slot 1)
# needs slot 2, which row 1 (walk 1, step 1) writes only once it has
# slot 1. ``build_walks`` refuses such a program, so it is made by hand.
_STALL = textwrap.dedent("""
    import json, sys, time
    import numpy as np
    import torch
    from repro_torch.kernels import megabatch_scan as scan

    i32 = lambda a: np.asarray(a, dtype=np.int32)
    w = scan.Walks(out=i32([1, 2]), dep=i32([[0, 2, 0], [0, 1, 0]]),
                   delay=np.zeros((2, 3)), dur=np.ones(2), step=i32([0, 1]),
                   walk_ptr=i32([0, 1, 2]), lane_walk_ptr=i32([0, 2]),
                   n_slots=4).to("cuda")
    scan._library()                     # built before the clock starts
    t0 = time.perf_counter()
    try:
        scan._scan_walks_cuda(w)
        torch.cuda.synchronize()
        got = "returned"
    except RuntimeError as e:
        got = "RuntimeError: " + str(e).splitlines()[0]
    print(json.dumps({"got": got, "seconds": time.perf_counter() - t0}))
""")


@pytest.mark.gpu
def test_a_stalled_wait_traps_and_raises():
    """Needs a CUDA device and nvcc: a wait that never ends trips the
    kernel's 10 s watchdog, which traps; the trap surfaces as a
    RuntimeError at the next synchronising call instead of hanging the
    card. Runs in a child process, because a trap ruins the CUDA
    context of the process it happens in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    run = subprocess.run([sys.executable, "-c", _STALL], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    print("stalled wait:", json.dumps(got))
    assert got["got"].startswith("RuntimeError"), got
    # the watchdog, not a fault at launch: about 10 s, well under 15 s
    assert 9.0 <= got["seconds"] <= 15.0, got
