"""Reading a profiled sub-window (``bench/tracing.py``) from stand-in
events: the union of the device's intervals, the idle gaps, and the
kernels each span ran between its markers, those linked to no host op
included; and the profiler's warm-up and sub-window on the CPU."""
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

from bench import tracing


def ev(name, a, b, device=False, id=0, linked=0):
    return NS(name=name, device_type=DeviceType.CUDA if device
              else DeviceType.CPU, activity_type="kernel" if device else
              "cpu_op", id=id, linked_correlation_id=linked,
              time_range=NS(start=a, end=b, elapsed_us=lambda: b - a))


OPEN, CLOSE = "spin_kernel", "void _assert_async_cuda_kernel<bool>"


def events():
    return [
        ev(OPEN, 0, 1, device=True),                 # the window opens
        ev(CLOSE, 1, 2, device=True),
        ev("cudaLaunchKernel", 11, 12, id=3),
        ev("cudaStreamSynchronize", 40, 60, id=5),
        ev(OPEN, 14, 15, device=True),               # attention.fwd opens
        ev("k_mm", 15, 25, device=True, linked=3),
        ev("k_own", 25, 35, device=True),            # launched by a library
        ev(CLOSE, 35, 36, device=True),              # and closes
        ev(OPEN, 45, 46, device=True),               # moe_ffn opens
        ev("k_sort", 50, 60, device=True, linked=5),
        ev(CLOSE, 61, 62, device=True),              # and closes
        ev(OPEN, 99, 100, device=True),              # the window closes
        ev(CLOSE, 100, 101, device=True),
    ]


LABELS = [tracing.WINDOW, "attention.fwd", "moe_ffn", tracing.WINDOW]


def test_each_span_holds_the_kernels_between_its_markers():
    s = tracing.summarize(events(), LABELS)
    assert s.span_s == {"attention.fwd": pytest.approx(20e-6),
                        "moe_ffn": pytest.approx(10e-6)}
    assert s.span_count == {"attention.fwd": 1, "moe_ffn": 1}
    assert s.spans_lost == 0


@pytest.mark.parametrize("lost", [4, 7])
def test_a_span_whose_marker_is_lost_is_left_out(lost):
    """Without moe_ffn's first (open) or attention.fwd's last (close)
    marker, that span is left out and the others keep their names."""
    evs = events()
    del evs[lost]
    labels = LABELS[:3] + ["attention.fwd", "moe_ffn"] + LABELS[3:]
    evs[-2:-2] = [ev(OPEN, 70, 71, device=True),
                  ev("k_mm", 71, 75, device=True),
                  ev(CLOSE, 75, 76, device=True),
                  ev(OPEN, 80, 81, device=True),
                  ev("k_sort", 81, 83, device=True),
                  ev(CLOSE, 83, 84, device=True)]
    s = tracing.summarize(evs, labels)
    assert s.spans_lost == 1
    if lost == 4:       # attention.fwd's first span is gone: 4 us a span
        assert s.span_s["attention.fwd"] == pytest.approx(8e-6)
        assert s.span_s["moe_ffn"] == pytest.approx(12e-6)
    else:               # its close is gone: the same
        assert s.span_s["attention.fwd"] == pytest.approx(8e-6)
    assert s.span_count == {"attention.fwd": 2, "moe_ffn": 2}


def test_busy_time_gaps_and_what_the_host_was_doing():
    s = tracing.summarize(events(), LABELS)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert [g for _, g in s.idle_gaps] == pytest.approx([40e-6, 15e-6,
                                                         15e-6])
    assert all("spin" not in n for n, _ in s.device_ops)
    assert s.idle_gaps[0][0] == "host after k_sort"
    named = dict(s.idle_gaps)
    assert named["cudaStreamSynchronize after k_own"] == pytest.approx(15e-6)
    assert named["host after the window's start"] == pytest.approx(15e-6)
    assert s.device_ops[0] == ("k_mm", pytest.approx(10e-6))


def test_markers_that_do_not_pair_with_the_spans_are_refused():
    with pytest.raises(RuntimeError):
        tracing.summarize(events(), LABELS[:-1])


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        tracing.summarize([e for e in events() if e.device_type ==
                           DeviceType.CPU], [])


def test_the_profiler_drops_its_warm_up_and_splits_the_window(monkeypatch):
    """Units 1 (warm-up, traced and dropped) and 2-3 (recorded) of six:
    the summary reads the recorded ones, and the rest are outside."""
    prof = tracing.Profiler(warmup=1, first=2, last=4)
    shapes, done = [], 0
    while True:
        prof.at(done)
        with torch.profiler.record_function(f"unit{done}"):
            torch.ones(8) @ torch.ones(8)
        shapes.append((1, 10 + done))
        done += 1
        if done >= 6 and prof.done(done):
            break
    names = {e.name for e in prof.prof.events()}
    assert {"unit2", "unit3"} <= names
    assert not names & {"unit0", "unit1", "unit4", "unit5"}
    monkeypatch.setattr(tracing, "summarize", lambda events, labels, top=10: NS(
        profiled=[], outside=[], outside_s=0.0, spans_lost=0))
    s = prof.summary(shapes, window_s=5.0)
    assert s.profiled == [(1, 12), (1, 13)]
    assert s.outside == [(1, 10), (1, 14), (1, 15)]
    assert 0 < s.outside_s < 5.0
