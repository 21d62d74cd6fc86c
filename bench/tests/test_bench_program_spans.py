"""Reading the program's own spans on a profile's clock
(``bench/program_spans.py``) from stand-in events: the clock offset from
a marker's launch, kernels given to spans by their launch, idle gaps put
down to the span of the launch that ends them (or the span open at the
gap's middle where no launch is linked), the four readers, and the
recording's extent on the CPU."""
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

from bench import harness, program_spans, tracing
from repro_torch.telemetry import Span

OPEN, CLOSE = "spin_kernel", "void _assert_async_cuda_kernel<bool>"


def dev(name, a, b, id):
    return NS(name=name, device_type=DeviceType.CUDA, id=id,
              time_range=NS(start=a, end=b, elapsed_us=lambda: b - a))


def cpu(name, a, b, id=0):
    return NS(name=name, device_type=DeviceType.CPU, id=id,
              time_range=NS(start=a, end=b, elapsed_us=lambda: b - a))


def events():
    """Trace microseconds; the host's are the trace's plus 1000."""
    return [
        cpu("cudaLaunchKernel", 0.5, 1.0, id=1),
        dev(OPEN, 2, 3, id=1),                   # the window opens
        cpu("cudaLaunchKernel", 1.0, 1.5, id=2),
        dev(CLOSE, 3, 4, id=2),
        cpu("Activity Buffer Request", 5, 6, id=10),   # CUPTI's own
        cpu("cudaLaunchKernel", 11, 11.5, id=10),      # in lm.layer
        dev("k_a", 12, 20, id=10),
        cpu("cudaLaunchKernel", 20, 20.5, id=11),      # attention.fwd
        dev("k_b", 30, 45, id=11),
        cpu("cudaLaunchKernel", 54, 54.5, id=12),      # lm.backward
        dev("k_c", 55, 60, id=12),
        cpu("cuLaunchKernelEx", 61, 61.5, id=13),      # attention.bwd
        dev("k_d", 62, 70, id=13),
        dev("k_e", 85, 88, id=14),                     # no launch record
        cpu("cudaLaunchKernel", 93, 93.5, id=20),
        dev(OPEN, 95, 96, id=20),                # the window closes
        cpu("cudaLaunchKernel", 94, 94.5, id=21),
        dev(CLOSE, 96, 97, id=21),
    ]


def spans():
    """A warm-up step before the window, then the profiled one; the
    backward's attention on a thread of its own."""
    return [Span("step.train", 900_000, 990_000, -1, 0, 1),
            Span("step.train", 1_005_000, 1_090_000, -1, 1, 1),
            Span("lm.layer", 1_010_000, 1_040_000, 1, 1, 1),
            Span("attention.fwd", 1_015_000, 1_035_000, 2, 1, 1),
            Span("lm.backward", 1_050_000, 1_080_000, 1, 1, 1),
            Span("attention.bwd", 1_060_000, 1_070_000, 4, 1, 2)]


COUNTS = {0: {"host_sync": 99}, 1: {"host_sync": 24}}
#: the host stamps before the window's two markers at each end; the
#: smaller reading of each pair puts the trace 1000 us behind the host at
#: the opening, 998 at the close (a drift of 2 us)
STAMPS = (1_000_500, 1_000_900, 1_091_000, 1_091_500)
LABELS = [tracing.WINDOW, tracing.WINDOW]


def read(evs=None):
    return program_spans.read(events() if evs is None else evs, spans(),
                              COUNTS, STAMPS)


def test_the_clock_offset_is_read_from_each_markers_launch():
    p, _ = read()
    assert p.offsets_us == pytest.approx((-1000.0, -998.0))
    calls = program_spans._launch_calls(events())
    assert calls[10] == 11              # CUPTI's buffer request left out
    assert program_spans.clock_offset(
        [1_000_000, 0], [dev(OPEN, 2, 3, id=1), dev(CLOSE, 3, 4, id=2)],
        calls) == pytest.approx(-999.5)
    with pytest.raises(RuntimeError, match="no launch"):
        program_spans.clock_offset([0], [dev(OPEN, 0, 1, id=99)], calls)


def test_only_the_units_inside_the_window_are_read():
    p, _ = read()
    assert p.units == [("step.train", pytest.approx(85e-6),
                        {"host_sync": 24})]
    assert p.unit_count("step.train") == 1
    assert p.unit_count("step.prefill") == 0


def test_host_time_of_each_span_and_its_self_time():
    """The window's unit only; a span's self time leaves out its
    children's, those on another thread included."""
    p, _ = read()
    assert p.host_s == pytest.approx({
        "step.train": 85e-6, "lm.layer": 30e-6, "attention.fwd": 20e-6,
        "lm.backward": 30e-6, "attention.bwd": 10e-6})
    assert p.self_host_s == pytest.approx({
        "step.train": 25e-6, "lm.layer": 10e-6, "attention.fwd": 20e-6,
        "lm.backward": 20e-6, "attention.bwd": 10e-6})


def test_kernels_are_given_to_the_span_they_were_launched_in():
    """Each kernel to the innermost span open at its launch, on any
    thread (k_d's launch on the backward's thread); a span's device time
    holds its children's."""
    p, _ = read()
    assert p.self_device_s == {
        "lm.layer": pytest.approx(8e-6), "attention.fwd": pytest.approx(
            15e-6), "lm.backward": pytest.approx(5e-6),
        "attention.bwd": pytest.approx(8e-6)}
    assert p.device_s == {
        "step.train": pytest.approx(36e-6), "lm.layer": pytest.approx(
            23e-6), "attention.fwd": pytest.approx(15e-6),
        "lm.backward": pytest.approx(13e-6),
        "attention.bwd": pytest.approx(8e-6)}
    assert p.unlinked == pytest.approx(3 / 39)


def test_each_gap_goes_to_the_span_of_the_launch_that_ends_it():
    """The first gap's middle lies in step.train alone, but the kernel
    that ends it was launched inside lm.layer; k_e has no launch record,
    so its gap goes to the span open at the gap's middle; the last gap
    ends at the window's marker, launched outside the program, with the
    host in no CUDA call at its middle."""
    p, named = read()
    assert p.idle_s == pytest.approx(55e-6)
    assert p.span_idle_s == {
        "lm.layer": pytest.approx(10e-6),
        "attention.fwd": pytest.approx(10e-6),
        "lm.backward": pytest.approx(25e-6),
        "attention.bwd": pytest.approx(2e-6)}
    assert p.host_idle_s == pytest.approx(47e-6)
    assert p.plain_host_s == pytest.approx(8e-6)
    s = tracing.summarize(events(), LABELS)
    assert [g for _, g in s.idle_gaps] == pytest.approx(
        [15e-6, 10e-6, 10e-6, 10e-6, 8e-6, 2e-6])
    assert program_spans.relabel(s.idle_gaps, named) == [
        ("lm.backward/host after k_d", pytest.approx(15e-6)),
        ("lm.backward/host after k_b", pytest.approx(10e-6)),
        ("attention.fwd/host after k_a", pytest.approx(10e-6)),
        ("lm.layer/host after the window's start", pytest.approx(10e-6)),
        ("host after k_e", pytest.approx(8e-6)),
        ("attention.bwd/cuLaunchKernelEx after k_c", pytest.approx(2e-6))]


def test_a_gap_in_a_cuda_call_outside_the_program_is_not_plain_host():
    evs = events() + [cpu("cudaStreamSynchronize", 90, 93)]
    p, _ = read(evs)
    assert p.plain_host_s == 0.0 and p.host_idle_s == pytest.approx(47e-6)


def summary(p=None):
    return NS(program=p) if p is not None else NS()


TRAIN, PREFILL = NS(kind="train"), NS(kind="prefill")


def test_the_readers_on_a_training_summary():
    p, _ = read()
    s = summary(p)
    assert harness.metric_reader("host_syncs.train")(s, TRAIN) == 24
    assert harness.metric_reader("host_idle_ms.train")(s, TRAIN) == \
        pytest.approx(0.047)
    assert harness.metric_reader("host_idle_ms.prefill")(s, PREFILL) is None
    assert harness.metric_reader("issue_ms.prefill")(s, PREFILL) is None


def test_the_readers_on_a_prefill_summary():
    p, _ = read()
    p.units = [("step.prefill", 0.010, {}), ("step.prefill", 0.020, {})]
    s = summary(p)
    assert harness.metric_reader("issue_ms.prefill")(s, PREFILL) == \
        pytest.approx(15.0)
    assert harness.metric_reader("host_idle_ms.prefill")(s, PREFILL) == \
        pytest.approx(0.0235)
    assert harness.metric_reader("host_syncs.train")(s, TRAIN) is None


@pytest.mark.parametrize("name,kind", [
    ("host_syncs.train", TRAIN), ("host_idle_ms.train", TRAIN),
    ("host_idle_ms.prefill", PREFILL), ("issue_ms.prefill", PREFILL)])
def test_each_reader_finds_nothing_without_the_programs_records(name, kind):
    """The harness's own profiler (and a program without spans) leaves
    the summary without ``program``: no reading, no error."""
    assert harness.metric_reader(name)(summary(), kind) is None


def test_a_step_that_syncs_nowhere_reads_zero():
    p, _ = read()
    p.units = [("step.train", 1.0, {})]
    assert harness.metric_reader("host_syncs.train")(summary(p),
                                                     TRAIN) == 0.0


def test_the_profiler_records_from_its_warm_up_to_the_windows_close():
    """Units 1 (warm-up) and 2-3 (profiled) of six are recorded, and
    the host is stamped before each of the window's opening markers."""
    from repro_torch import telemetry
    prof = program_spans.ProgramProfiler(warmup=1, first=2, last=4,
                                         kind="train")
    done = 0
    while True:
        prof.at(done)
        with telemetry.span("step.train"):
            torch.ones(8) @ torch.ones(8)
        done += 1
        if done >= 6 and prof.done(done):
            break
    units = [s for s in prof.records.spans if s.parent < 0]
    assert len(units) == 3
    assert len(prof.stamps) == 4 and prof.stamps == sorted(prof.stamps)
    assert units[0].end_ns <= prof.stamps[0] < prof.stamps[1] <= \
        units[1].start_ns
    assert units[2].end_ns <= prof.stamps[2]
    assert telemetry.span("x") is telemetry.span("y")     # off again
