"""The program's own spans and counters (``repro_torch.telemetry``), read
on the clock of a traced run's profile.

:class:`ProgramProfiler` is :class:`bench.tracing.Profiler` with the
program's recording on from the profiler's warm-up to the sub-window's
close, so the units whose time ``mfu.*`` reads, and every untraced run,
record nothing. Just before each of the sub-window's two opening markers
is launched, and again before its closing marker, it stamps the host's
clock (``perf_counter_ns``). Each marker's launch record in the profile
(the CUDA runtime call that shares the marker's correlation id) puts its
stamp on the trace's timeline. A launch record starts some microseconds
after its stamp, the Python call into the runtime, and more after a
pause; the smaller of a pair's two readings has the less of that delay
in it. So the offset between the two clocks is read at the window's
opening pair of markers, and again at its closing pair.

On that clock:

* each kernel, copy and memset of the sub-window is given to the program
  span that was open when the host launched it (the runtime call that
  shares its correlation id): the innermost span open at that instant.
  The profile's runtime records do not tell the host's threads apart,
  and need not: a span opened on the autograd engine's thread nests
  under the innermost span of the unit's own thread, so the deepest span
  open at a launch is the launching thread's innermost one, or the unit
  thread's where the launching thread has none open;
* each idle gap of the device is put down to the span in which the host
  launched the operation that ends it, where the device waited on the
  host; where no launch record is linked, to the span open at the gap's
  middle. The breakdown's gap labels gain that span in front:
  ``<span>/<cuda call or host> after <kernel>``.

Run a cell's traced run (``bench/run.py --trace 1``) with this profiler
in place of the harness's own, from the checkout's root::

    python3 -m bench.program_spans --workload <cell> --seed <n> \
        --seconds <s>

It prints one line to standard error, ``program spans: {...}``: both
clock offsets, the per-layer readings of ``metrics/host_syncs.train.py``,
``metrics/host_idle_ms.py`` and ``metrics/issue_ms.prefill.py``, the
device seconds launched in each program span beside the harness's own
spans' (``bench/spans.py``), the idle put down to each span, and the
share of device work with no launch record.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

from bench import spans as spans_mod
from bench import tracing

#: the program's unit spans by traffic kind
UNIT = {"train": "step.train", "prefill": "step.prefill"}
#: the readers of the per-layer metrics built on the program's records
METRICS = {"train": ("host_syncs.train", "host_idle_ms.train"),
           "prefill": ("host_idle_ms.prefill", "issue_ms.prefill")}


@dataclasses.dataclass
class Program:
    """What the program's records say about the sub-window."""
    #: each unit inside the sub-window: its span's name, its host
    #: seconds and each counter's increase over it
    units: List[Tuple[str, float, Dict[str, int]]]
    #: the offset, in microseconds, to add to ``perf_counter_ns() / 1e3``
    #: for the trace's time, read at the opening and the closing markers
    offsets_us: Tuple[float, float]
    #: host seconds in each span over the units, its children's
    #: included, and in the span itself
    host_s: Dict[str, float]
    self_host_s: Dict[str, float]
    idle_s: float
    #: idle put down to a program span, and by span (the innermost)
    host_idle_s: float
    span_idle_s: Dict[str, float]
    #: idle in no program span with the host in no CUDA call
    plain_host_s: float
    #: device seconds of the work launched inside each span, its
    #: children's included, and in the span itself
    device_s: Dict[str, float]
    self_device_s: Dict[str, float]
    #: the share of the sub-window's device seconds with no launch record
    unlinked: float

    def unit_count(self, name: str) -> int:
        return sum(n == name for n, _, _ in self.units)


def _launch_calls(events) -> Dict[int, float]:
    """The start, on the trace's clock, of the runtime call behind each
    correlation id: the earliest host record of that id whose name is a
    CUDA call (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaMemcpyAsync``, ...; CUPTI's own records that share the id,
    such as its buffer requests, are left out)."""
    from torch.autograd import DeviceType
    out: Dict[int, float] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.id and \
                e.name.startswith("cu"):
            t = e.time_range.start
            if t < out.get(e.id, float("inf")):
                out[e.id] = t
    return out


def _launched(e, calls: Dict[int, float]) -> Optional[float]:
    """When the host launched device work ``e``, or None."""
    for key in (e.id, getattr(e, "linked_correlation_id", 0)):
        if key and key in calls:
            return calls[key]
    return None


def clock_offset(stamps: Sequence[int], markers,
                 calls: Dict[int, float]) -> float:
    """The trace's time minus the host's, in microseconds: the smallest
    of each marker's launch record against the host stamp taken just
    before it."""
    out = []
    for stamp, marker in zip(stamps, markers):
        t = _launched(marker, calls)
        if t is None:
            raise RuntimeError(f"the profile holds no launch of the marker "
                               f"{marker.name!r}")
        out.append(t - stamp / 1e3)
    return min(out)


class SpanClock:
    """The innermost program span open at each instant, on the trace's
    clock: the deepest of those open on any thread."""

    def __init__(self, spans: Sequence, offset_us: float):
        self.spans = spans
        depth: List[int] = []
        for s in spans:
            depth.append(0 if s.parent < 0 else depth[s.parent] + 1)
        moves = []
        for i, s in enumerate(spans):
            moves.append((s.start_ns, 1, i))
            if s.end_ns >= 0:
                moves.append((s.end_ns, 0, i))
        moves.sort()
        self.times: List[float] = []
        self.owner: List[int] = []
        open_: Dict[int, int] = {}
        k = 0
        while k < len(moves):
            t = moves[k][0]
            while k < len(moves) and moves[k][0] == t:
                _, opens, i = moves[k]
                if opens:
                    open_[i] = depth[i]
                else:
                    open_.pop(i, None)
                k += 1
            inner = max(open_, key=lambda i: (open_[i], i)) if open_ else -1
            self.times.append(t / 1e3 + offset_us)
            self.owner.append(inner)

    def at(self, t_us: float) -> int:
        """The index of the innermost span open at ``t_us``, or -1."""
        k = bisect.bisect_right(self.times, t_us) - 1
        return self.owner[k] if k >= 0 else -1

    def chain(self, i: int) -> List[str]:
        """The names of span ``i`` and its ancestors, each once."""
        names: List[str] = []
        while i >= 0:
            if self.spans[i].name not in names:
                names.append(self.spans[i].name)
            i = self.spans[i].parent
        return names


def _in_a_call(t: float, host) -> bool:
    return any(a <= t <= b for a, b in host)


def read(events, spans: Sequence, counts: Dict[int, Dict[str, int]],
         stamps: Sequence[int], top: int = 10):
    """The :class:`Program` of a profile's ``events`` with the program's
    ``spans`` and ``counts`` recorded over it, and the span (or None) of
    each of the ``top`` longest idle gaps, in the order of
    :func:`bench.tracing.summarize`'s ``idle_gaps``. ``stamps``: the host
    stamps before the sub-window's two opening markers and its two
    closing ones."""
    from torch.autograd import DeviceType
    device = [e for e in events if tracing.is_device_work(e)]
    marks = sorted((e for e in device if spans_mod.OPEN in e.name
                    or spans_mod.CLOSE in e.name),
                   key=lambda e: e.time_range.start)
    work = [e for e in device if spans_mod.OPEN not in e.name
            and spans_mod.CLOSE not in e.name]
    w0, w1 = marks[0].time_range.start, marks[-1].time_range.start
    calls = _launch_calls(events)
    offsets = (clock_offset(stamps[:2], marks[:2], calls),
               clock_offset(stamps[2:], marks[-2:], calls))
    clock = SpanClock(spans, offsets[0])

    inside = {s.unit for s in spans if s.parent < 0 and stamps[0] <=
              s.start_ns and 0 <= s.end_ns <= stamps[2]}
    units = [(s.name, (s.end_ns - s.start_ns) / 1e9, counts.get(s.unit, {}))
             for s in spans if s.parent < 0 and s.unit in inside]
    host_s: Dict[str, float] = {}
    self_host: Dict[str, float] = {}
    for s in spans:
        if s.unit in inside:
            t = (s.end_ns - s.start_ns) / 1e9
            host_s[s.name] = host_s.get(s.name, 0.0) + t
            self_host[s.name] = self_host.get(s.name, 0.0) + t
            if s.parent >= 0:
                up = spans[s.parent].name
                self_host[up] = self_host.get(up, 0.0) - t

    device_s: Dict[str, float] = {}
    self_s: Dict[str, float] = {}
    total = unlinked = 0.0
    for e in work:
        if not w0 <= e.time_range.start < w1:
            continue
        us = e.time_range.elapsed_us()
        total += us
        t = _launched(e, calls)
        if t is None:
            unlinked += us
            continue
        i = clock.at(t)
        if i < 0:
            continue
        self_s[spans[i].name] = self_s.get(spans[i].name, 0.0) + us / 1e6
        for name in clock.chain(i):
            device_s[name] = device_s.get(name, 0.0) + us / 1e6

    ivs = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
           for e in work if e.time_range.end > w0 and e.time_range.start < w1]
    _, merged = tracing._union(ivs)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    ordered = sorted(device, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ordered]
    host = [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU]
    owner_of: Dict[Tuple[float, float], int] = {}
    span_idle: Dict[str, float] = {}
    host_idle = plain = 0.0
    for g, a, b in gaps:
        k = bisect.bisect_left(starts, b)
        t = _launched(ordered[k], calls) if k < len(ordered) else None
        i = clock.at(t if t is not None else (a + b) / 2)
        owner_of[(a, b)] = i
        if i >= 0:
            host_idle += g
            name = spans[i].name
            span_idle[name] = span_idle.get(name, 0.0) + g / 1e6
        elif not _in_a_call((a + b) / 2, host):
            plain += g
    named = [spans[owner_of[(a, b)]].name if owner_of[(a, b)] >= 0 else None
             for g, a, b in sorted(gaps, reverse=True)[:top]]
    program = Program(
        units=units, offsets_us=offsets, host_s=host_s,
        self_host_s=self_host,
        idle_s=sum(g for g, _, _ in gaps) / 1e6,
        host_idle_s=host_idle / 1e6, span_idle_s=span_idle,
        plain_host_s=plain / 1e6, device_s=device_s, self_device_s=self_s,
        unlinked=unlinked / total if total else 0.0)
    return program, named


def relabel(idle_gaps, named) -> list:
    """``idle_gaps`` with each gap's span in front of its label."""
    return [(f"{span}/{label}" if span else label, g)
            for (label, g), span in zip(idle_gaps, named)]


class ProgramProfiler(tracing.Profiler):
    """:class:`bench.tracing.Profiler` with the program's recording and
    the host stamps of the sub-window's markers; its summary carries the
    :class:`Program` as ``program``."""

    def __init__(self, warmup: int, first: int, last: int, kind: str):
        super().__init__(warmup, first, last)
        self.kind = kind
        self.records = None
        self.stamps: List[int] = []

    def at(self, done: int) -> None:
        # the harness's own sequence (tracing.Profiler.at), with the
        # recording entered at ``begin`` and a stamp before each marker
        # that opens or closes the sub-window
        if done == self.begin:
            spans_mod.mark(close=True)
            tracing._sync()
            self.wall = -time.perf_counter()
            self.prof.start()
            self.stack.enter_context(spans_mod.named_spans(self.log))
            from repro_torch import telemetry
            self.records = self.stack.enter_context(telemetry.recording())
        if done == self.first:
            tracing._sync()
            self.prof.step()
            time.sleep(tracing.SETTLE_S)
            self.log[:] = [tracing.WINDOW]
            self._marks()
        if done == self.last:
            tracing._sync()
            self.log.append(tracing.WINDOW)
            self._marks()
            tracing._sync()
            time.sleep(tracing.SETTLE_S)
            self.stack.close()
            self.prof.stop()
            self.wall += time.perf_counter()

    def _marks(self) -> None:
        """The sub-window's two markers, each after a host stamp."""
        self.stamps.append(time.perf_counter_ns())
        spans_mod.mark()
        self.stamps.append(time.perf_counter_ns())
        spans_mod.mark(close=True)

    def summary(self, shapes, window_s: float, top: int = 10):
        s = super().summary(shapes, window_s, top)
        s.program, named = read(self.prof.events(), self.records.spans,
                                self.records.counts, self.stamps, top)
        s.idle_gaps = relabel(s.idle_gaps, named)
        print("program spans: " + json.dumps(report(s, self.kind)),
              file=sys.stderr)
        return s


def report(s, kind: str) -> dict:
    """The line that :class:`ProgramProfiler` prints."""
    from bench import harness
    p = s.program
    cell = SimpleNamespace(kind=kind)
    return {
        "offsets_us": list(p.offsets_us),
        "offset_drift_us": p.offsets_us[1] - p.offsets_us[0],
        "units": p.unit_count(UNIT[kind]),
        "metrics": {m: harness.metric_reader(m)(s, cell)
                    for m in METRICS[kind]},
        "host_s": p.host_s, "self_host_s": p.self_host_s,
        "idle_s": p.idle_s, "host_idle_s": p.host_idle_s,
        "plain_host_share": p.plain_host_s / p.idle_s if p.idle_s else 0.0,
        "span_idle_s": p.span_idle_s,
        "device_s": p.device_s, "self_device_s": p.self_device_s,
        "outside_span_s": s.span_s, "unlinked_share": p.unlinked}


def profiler(mix: dict) -> ProgramProfiler:
    """:func:`bench.tracing.profiler` with the program's spans."""
    first = mix["profile_after"]
    return ProgramProfiler(mix["profile_warmup"], first,
                           first + mix["profiled"], mix["kind"])


def main(argv=None) -> int:
    from bench import run
    tracing.profiler = profiler
    return run.main(list(argv if argv is not None else sys.argv[1:])
                    + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
