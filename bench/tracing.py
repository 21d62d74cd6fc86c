"""Reading a ``torch.profiler`` trace of a profiled sub-window.

The traced run profiles a few steady steps or requests inside its timed
window. The profiler records the device's activity alone (CUPTI), and
no host ops: recording every op on the host slows a path that the host
paces, and what the trace would read as the device's idle time would be
the profiler's. It is started some units before the sub-window and
traces those in its warm-up, whose records it drops: the first kernels
it sees pay its own start-up. Markers on the stream (``bench.spans.
mark``) open and close each span of :func:`bench.spans.named_spans`,
whose names the spans log in order, and two empty spans open and close
the sub-window, after a ``synchronize()`` each. CUPTI may lose a record
now and then: a span one of whose markers is lost is left out, and the
others of its name stand for it. From the trace: the device's busy time
(the union of its kernels', copies' and memsets' intervals), the
sub-window's length, the device time of the kernels run inside each
span, the device operations that took most time, and the longest idle
gaps of the device, each named by the CUDA call the host was in at its
middle (``host`` where it was in none) and by the operation before it.
The markers are left out of the rest.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Tuple

import torch

from bench import spans as spans_mod

#: the name of the two empty spans that open and close the sub-window
WINDOW = "bench.window"
#: seconds left between the profiler's start of recording, or its stop,
#: and the sub-window's markers: the profiler keeps only what its own
#: clock puts inside, and the device's stamps, brought to the host's
#: clock, may lie some microseconds off
SETTLE_S = 0.005
#: profiler activity types that are work on the device
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    """What the per-layer metrics read."""
    busy_s: float
    window_s: float
    span_s: Dict[str, float]            # device seconds inside each span
    span_count: Dict[str, int]
    #: spans of which the trace lacks a marker; each span's seconds are
    #: those of the spans read, scaled to all of its count
    spans_lost: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    #: (rows, sequence length) of each step or request profiled
    profiled: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    #: those of the timed window's units that ran with the profiler off,
    #: and their seconds on the host's clock
    outside: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    outside_s: float = 0.0

    @property
    def units(self) -> int:
        return len(self.profiled)


def is_device_work(e) -> bool:
    """A kernel, copy or memset on the card's timeline (not the user
    annotations and overhead records the profiler also puts there)."""
    from torch.autograd import DeviceType
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in DEVICE_WORK
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("aten::")
            and e.name != "Command Buffer Full")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profiler:
    """Profiles a timed window's units ``first`` to ``last`` (not
    included), after ``warmup`` units that it traces and drops. The
    traffic driver calls :meth:`at` before each unit, with the count of
    units done, and :meth:`summary` once the window has closed."""

    def __init__(self, warmup: int, first: int, last: int):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.begin, self.first, self.last = first - warmup, first, last
        self.wall = 0.0
        self.log: List[str] = []
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
            else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1))
        self.stack = contextlib.ExitStack()

    def at(self, done: int) -> None:
        if done == self.begin:
            spans_mod.mark(close=True)
            _sync()
            self.wall = -time.perf_counter()
            self.prof.start()
            self.stack.enter_context(spans_mod.named_spans(self.log))
        if done == self.first:
            _sync()
            self.prof.step()
            time.sleep(SETTLE_S)
            self.log[:] = [WINDOW]
            spans_mod.mark()
            spans_mod.mark(close=True)
        if done == self.last:
            _sync()
            self.log.append(WINDOW)
            spans_mod.mark()
            spans_mod.mark(close=True)
            _sync()
            time.sleep(SETTLE_S)
            self.stack.close()
            self.prof.stop()
            self.wall += time.perf_counter()

    def done(self, units: int) -> bool:
        return units > self.last

    def summary(self, shapes, window_s: float, top: int = 10) -> Summary:
        """The trace's summary, with the ``shapes`` of every unit of a
        timed window of ``window_s`` seconds that held the sub-window."""
        s = summarize(self.prof.events(), self.log, top)
        print(f"spans whose marker the trace lost: {s.spans_lost} of "
              f"{len(self.log)}", file=sys.stderr)
        s.profiled = list(shapes[self.first:self.last])
        s.outside = list(shapes[:self.begin]) + list(shapes[self.last:])
        s.outside_s = window_s - self.wall
        return s


def profiler(mix: dict) -> Profiler:
    """The profiler of a mix: ``profiled`` units from the window's unit
    ``profile_after``, after ``profile_warmup`` units of its warm-up."""
    first = mix["profile_after"]
    return Profiler(mix["profile_warmup"], first, first + mix["profiled"])


def _union(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """The length of the union of (start, end) intervals and its merged
    pieces, in order."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def pair_markers(labels, marks):
    """(name, open, close) of each span whose two markers the trace
    holds, and the count of those whose marker it lacks. ``marks`` are
    (start, is_close) in device order; the k-th name of ``labels`` owns
    the k-th span. A lost close shows as two opens in a row, a lost open
    as two closes; the span is then left out."""
    pairs, lost, k, opened = [], 0, 0, None
    for t, close in marks:
        if not close:
            if opened is not None:
                lost, k = lost + 1, k + 1
            opened = t
        elif opened is None:
            lost, k = lost + 1, k + 1
        else:
            if k < len(labels):
                pairs.append((labels[k], opened, t))
            k, opened = k + 1, None
    if opened is not None:
        lost, k = lost + 1, k + 1
    if k != len(labels):
        raise RuntimeError(f"{k} spans marked on the device for "
                           f"{len(labels)} spans on the host")
    return pairs, lost


def span_times(labels, work, marks):
    """The device seconds of the kernels run between each span's two
    markers, scaled to every span of its name, and each span's count;
    and the count of spans a marker of which is lost."""
    pairs, lost = pair_markers(labels, marks)
    ordered = sorted(work, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ordered]
    total = [0.0]
    for e in ordered:
        total.append(total[-1] + e.time_range.elapsed_us())
    read: Dict[str, float] = {}
    seen: Dict[str, int] = {}
    for name, a, b in pairs:
        lo = bisect.bisect_right(starts, a)
        hi = bisect.bisect_left(starts, b)
        read[name] = read.get(name, 0.0) + (total[hi] - total[lo]) / 1e6
        seen[name] = seen.get(name, 0) + 1
    count: Dict[str, int] = {}
    for name in labels:
        count[name] = count.get(name, 0) + 1
    span_s = {n: read[n] * count[n] / seen[n] for n in read}
    return span_s, {n: count[n] for n in read}, lost


def summarize(events, labels, top: int = 10) -> Summary:
    """The summary of a trace whose markers pair with the span names
    ``labels`` in order, the first and the last the sub-window's own."""
    from torch.autograd import DeviceType
    device = [e for e in events if is_device_work(e)]
    is_mark = [spans_mod.OPEN in e.name or spans_mod.CLOSE in e.name
               for e in device]
    marks = sorted((e.time_range.start, spans_mod.CLOSE in e.name)
                   for e, m in zip(device, is_mark) if m)
    work = [e for e, m in zip(device, is_mark) if not m]
    if not work:
        raise RuntimeError("the profiler saw no work on the device")
    if not marks:
        raise RuntimeError("no markers of the sub-window on the device")
    w0, w1 = marks[0][0], marks[-1][0]
    ivs = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
           for e in work if e.time_range.end > w0 and e.time_range.start < w1]
    busy, merged = _union(ivs)
    by_name: Dict[str, float] = {}
    for e in work:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    span_s, span_count, lost = span_times(labels, work, marks)
    span_s.pop(WINDOW, None)
    span_count.pop(WINDOW, None)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU]
    ends = sorted((e.time_range.end, e.name) for e in work)

    def doing(t: float) -> str:
        inner = [(b - a, name) for a, b, name in host if a <= t <= b]
        return min(inner)[1][:40] if inner else "host"

    def before(t: float) -> str:
        i = bisect.bisect_right(ends, (t, chr(0x10FFFF)))
        return ends[i - 1][1][:55] if i else "the window's start"

    return Summary(
        busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
        span_s=span_s, span_count=span_count, spans_lost=lost,
        device_ops=[(n[:100], us / 1e6) for n, us in sorted(
            by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]],
        idle_gaps=[(f"{doing((a + b) / 2)} after {before(a)}", g / 1e6)
                   for g, a, b in gaps])
