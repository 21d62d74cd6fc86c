"""The port's mega-batch scan module (the one that holds the CUDA
kernel) against the reference: the same compiled programs, made from a
seed with numpy, go through both packages.

On the CPU the port runs the plain PyTorch versions: the step loop over
the padded planes (``scan_steps``) and, for the kernel's entry
``scan_walks``, the walk layout in step order; the kernel itself is held
against them on the card by ``chip_smoke.py`` and the ``gpu`` test.
Bars: bit-identity against the reference's float64 numpy path (the
arithmetic is ``+`` and ``max`` only); ``rtol=1e-5`` against the
reference's Pallas kernel, which runs in float32 in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config
from repro.core import (A40_CLUSTER, AnalyticalProvider, DistSim, Strategy,
                        MegaBatch)
from repro.kernels import megabatch_scan as ref_scan
from repro_torch.core.megabatch import PROGRAM_ARRAYS
from repro_torch.kernels import megabatch_scan as scan
from repro_torch.telemetry import COUNTS

PROVIDER = AnalyticalProvider(A40_CLUSTER)

# the heterogeneous ragged list of tests/test_megabatch.py
STRATS = [
    Strategy(mp=1, pp=1, dp=1, microbatches=1),
    Strategy(mp=1, pp=2, dp=2, microbatches=4),
    Strategy(mp=1, pp=4, dp=1, microbatches=8, schedule="gpipe"),
    Strategy(mp=2, pp=2, dp=1, microbatches=4, schedule="interleaved",
             vpp=2),
    Strategy(mp=1, pp=2, dp=2, microbatches=4, schedule="pipedream"),
    Strategy(mp=2, pp=2, dp=2, microbatches=4, zero1=True),
    Strategy(mp=1, pp=4, dp=2, microbatches=16, schedule="interleaved",
             vpp=3),
    Strategy(mp=1, pp=2, dp=2, microbatches=4, grad_compress=0.25),
    Strategy(mp=1, pp=8, dp=1, microbatches=8),
]


def reference_megabatch(strats=STRATS, seq=128):
    cfg = get_config("gpt2_345m")
    engines = [DistSim(cfg, s, s.dp * s.microbatches * 2, seq,
                       PROVIDER).engine() for s in strats]
    return MegaBatch(engines)


def program_arrays(mb) -> dict:
    """A reference MegaBatch's compiled program as plain numpy arrays."""
    arrays = {name: np.asarray(getattr(mb, name))
              for name in PROGRAM_ARRAYS}
    arrays["total"] = mb.total
    arrays["n_slots"] = mb.n_slots
    return arrays


class RandomProgram:
    """A random valid program laid out as the compiler lays one out:
    slot 0 the constant dummy, each lane's slots one contiguous range,
    every dependency either the dummy or a slot the SAME lane wrote at
    an earlier step, padding rows reading the dummy and writing the
    trash slot ``total + 1``. Duck-types what ``_eval_numpy`` reads."""

    def __init__(self, seed: int, K: int, max_len: int):
        rng = np.random.default_rng(seed)
        lens = rng.integers(1, max_len + 1, size=K)
        lens[rng.integers(K)] = max_len          # someone is the longest
        T, total = int(lens.max()), int(lens.sum())
        self.T, self.K, self.total = T, K, total
        self.n_slots = total + 2
        trash = total + 1
        self._len = lens.astype(np.int64)
        self._out = np.full((T, K), trash, dtype=np.int64)
        deps = [np.zeros((T, K), dtype=np.int64) for _ in range(3)]
        self._del1 = np.zeros((T, K))
        self._del2 = np.zeros((T, K))
        self._dur = np.zeros((T, K))
        base = 1
        for k, n in enumerate(lens):
            n = int(n)
            # a lane's slots in a shuffled (non-step) order
            slots = base + rng.permutation(n)
            self._out[:n, k] = slots
            for j in range(1, n):
                for d in deps:
                    if rng.random() < 0.7:
                        d[j, k] = slots[rng.integers(j)]
            self._del1[:n, k] = rng.random(n) * 1e-3
            self._del2[:n, k] = rng.random(n) * 1e-3
            self._dur[:n, k] = rng.random(n) * 1e-2
            base += n
        self._dep0, self._dep1, self._dep2 = deps

    _eval_numpy = MegaBatch._eval_numpy
    _stacked = MegaBatch._stacked


def tensors(prog, index_dtype=torch.int32):
    """A program's planes in the accelerator layout, on the CPU."""
    dep, delay = MegaBatch._stacked(prog)
    return (torch.from_numpy(prog._out).to(index_dtype),
            torch.from_numpy(dep).to(index_dtype),
            torch.from_numpy(delay), torch.from_numpy(prog._dur))


def lengths_of(prog):
    n = (prog._out != prog.total + 1).sum(axis=0)
    return torch.from_numpy(n.astype(np.int32))


def walks_of(prog):
    """A program's walk layout (what the kernel takes), on the host."""
    return scan.build_walks(prog._out, (prog._dep0, prog._dep1, prog._dep2),
                            (None, prog._del1, prog._del2), prog._dur,
                            prog._len, prog.n_slots)


def assert_bit_identical(prog, ends, starts):
    ref_ends, ref_starts = prog._eval_numpy()
    total = prog.total
    assert np.array_equal(ends.numpy(), ref_ends)
    assert np.array_equal(starts.numpy()[1: total + 1],
                          ref_starts[1: total + 1])


@pytest.mark.parametrize("seed,K,max_len", [
    (0, 1, 1), (1, 3, 17), (2, 37, 64), (3, 64, 200), (4, 5, 301)])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_plain_scan_bit_identical_on_random_programs(seed, K, max_len,
                                                     ragged, index_dtype):
    prog = RandomProgram(seed, K, max_len)
    out, dep, delay, dur = tensors(prog, index_dtype)
    lengths = lengths_of(prog).to(index_dtype) if ragged else None
    ends, starts = scan.scan_steps(out, dep, delay, dur, prog.n_slots,
                                   lengths=lengths)
    assert ends.dtype == torch.float64 and ends.shape == (prog.n_slots,)
    assert_bit_identical(prog, ends, starts)


@pytest.mark.parametrize("n", [1, 4, len(STRATS)])
@pytest.mark.parametrize("ragged", [False, True])
def test_plain_scan_bit_identical_on_compiled_programs(n, ragged):
    mb = reference_megabatch(STRATS[:n])
    out, dep, delay, dur = tensors(mb)
    lengths = lengths_of(mb) if ragged else None
    ends, starts = scan.scan_steps(out, dep, delay, dur, mb.n_slots,
                                   lengths=lengths)
    assert_bit_identical(mb, ends, starts)


def test_plain_scan_matches_reference_pallas_interpret():
    """Against the TPU kernel as the reference's own test runs it on
    the CPU: interpret mode, float32 — hence rtol 1e-5, not bits."""
    mb = reference_megabatch(STRATS[:5])
    dep, delay = mb._stacked()
    ref_ends, ref_starts = ref_scan.scan_steps(
        mb._out, dep, delay, mb._dur, mb.n_slots, backend="pallas")
    out_t, dep_t, delay_t, dur_t = tensors(mb)
    ends, starts = scan.scan_steps(out_t, dep_t, delay_t, dur_t,
                                   mb.n_slots, lengths=lengths_of(mb))
    total = mb.total
    np.testing.assert_allclose(ends.numpy()[1: total + 1],
                               ref_ends[1: total + 1], rtol=1e-5)
    np.testing.assert_allclose(starts.numpy()[1: total + 1],
                               ref_starts[1: total + 1], rtol=1e-5,
                               atol=1e-9)


def test_starts_are_per_slot_not_per_step():
    """The convention that keeps bubble fractions right: starts[s] is
    the start of the task whose END lives in slot s."""
    prog = RandomProgram(7, 4, 23)
    out, dep, delay, dur = tensors(prog)
    ends, starts = scan.scan_steps(out, dep, delay, dur, prog.n_slots)
    live = prog._out != prog.total + 1
    o = prog._out[live]
    np.testing.assert_array_equal(
        ends.numpy()[o] - starts.numpy()[o] >= 0, True)
    # end = start + dur, exactly, slot by slot
    assert np.array_equal(ends.numpy()[o],
                          starts.numpy()[o] + prog._dur[live])


@pytest.mark.parametrize("T,K", [(0, 0), (0, 3), (5, 0)])
def test_empty_programs_return_zeros(T, K):
    out = torch.zeros((T, K), dtype=torch.int32)
    dep = torch.zeros((T, K, 3), dtype=torch.int32)
    delay = torch.zeros((T, K, 3), dtype=torch.float64)
    dur = torch.zeros((T, K), dtype=torch.float64)
    ends, starts = scan.scan_steps(out, dep, delay, dur, 2)
    assert ends.tolist() == [0.0, 0.0] and starts.tolist() == [0.0, 0.0]


def _small():
    prog = RandomProgram(11, 3, 9)
    return prog, tensors(prog)


def test_cuda_backend_refuses_cpu_tensors():
    prog, _ = _small()
    w = walks_of(prog).to("cpu")
    before = COUNTS.get("k1.launches", 0)
    with pytest.raises(ValueError, match="CUDA device"):
        scan.scan_walks(w, backend="cuda")
    assert COUNTS.get("k1.launches", 0) == before  # nothing launched


def test_unknown_backend_raises():
    prog, _ = _small()
    with pytest.raises(ValueError, match="backend"):
        scan.scan_walks(walks_of(prog).to("cpu"), backend="pallas")


@pytest.mark.parametrize("which", ["delay", "dur"])
def test_wrong_float_dtype_raises(which):
    prog, (out, dep, delay, dur) = _small()
    if which == "delay":
        delay = delay.float()
    else:
        dur = dur.float()
    with pytest.raises(TypeError, match="float64"):
        scan.scan_steps(out, dep, delay, dur, prog.n_slots)


def test_wrong_index_dtype_raises():
    prog, (out, dep, delay, dur) = _small()
    with pytest.raises(TypeError, match="out"):
        scan.scan_steps(out.to(torch.int16), dep, delay, dur,
                        prog.n_slots)
    # the kernel takes int32 only: its checker refuses an int64 layout
    w = walks_of(prog).to("cpu")
    with pytest.raises(TypeError, match="int32"):
        scan.scan_walks(dataclasses.replace(w, dep=w.dep.long()))


def test_non_contiguous_input_raises():
    prog, (out, dep, delay, dur) = _small()
    wide = torch.zeros((prog.T, 2 * prog.K), dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        scan.scan_steps(out, dep, delay, wide[:, ::2], prog.n_slots)


def test_wrong_shape_raises():
    prog, (out, dep, delay, dur) = _small()
    with pytest.raises(ValueError, match="shape"):
        scan.scan_steps(out, dep[:, :, :2].contiguous(), delay, dur,
                        prog.n_slots)
    with pytest.raises(ValueError, match="lengths"):
        scan.scan_steps(out, dep, delay, dur, prog.n_slots,
                        lengths=torch.zeros(prog.K + 1, dtype=torch.int32))


@pytest.mark.gpu
def test_kernel_bit_identical_to_plain_on_the_card():
    """Needs a CUDA device and nvcc: builds the kernel and holds it
    against the plain version (``chip_smoke.py`` does the same at the
    full-width shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prog = RandomProgram(5, 70, 400)
    w = walks_of(prog).to("cuda")
    before = COUNTS.get("k1.launches", 0)
    ends, starts = scan.scan_walks(w, backend="cuda")
    torch.cuda.synchronize()
    assert COUNTS.get("k1.launches", 0) == before + 1
    assert_bit_identical(prog, ends.cpu(), starts.cpu())
    planes = [t.cuda() for t in tensors(prog)]
    pe, ps = scan.scan_steps(*planes, prog.n_slots,
                             lengths=lengths_of(prog).cuda())
    assert torch.equal(ends, pe) and torch.equal(starts, ps)
