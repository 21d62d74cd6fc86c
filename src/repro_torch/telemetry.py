"""The port's own spans and counters.

Spans mark the layer boundaries of the main path (the train step, the
prefill request, the forward, each layer, attention, the backward, the
optimizer); counters count what happens there (copies to the host,
kernel launches). A reader of the records gets each span's host time and
nesting, and each counter's increase in each unit of work.

* :func:`span` is a context manager. While nothing records it returns
  one shared object that does nothing: one global check a call, no
  allocation. While :func:`recording` is active it stamps the span's
  start and end with ``time.perf_counter_ns()``.
* A span opened with no span open is a *unit* (a training step, a
  request) and takes the next unit id; the spans opened inside it take
  its id and the index of their parent. Stacks are per thread: a span
  opened on a thread with no span open while a unit is open elsewhere
  (the autograd engine runs a CUDA backward on a thread of its own)
  takes as its parent the innermost span open on the unit's thread.
* :func:`count` adds to a process-wide counter, recording or not;
  :data:`COUNTS` holds the totals.
* :func:`recording` turns recording on for a block and yields the
  :class:`Records`: the spans, and each counter's increase in each unit.
  Nothing is written anywhere else.

Spans touch no tensor, so they change no number and work alike on
fake tensors and DTensors.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional


class Span(NamedTuple):
    """One span: its name, host stamps (``perf_counter_ns``), the index
    of its parent in :attr:`Records.spans` (-1 for a unit), its unit's
    id and the native id of the thread it ran on."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int
    thread: int


#: every counter's total since the process started
COUNTS: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTS[name] = COUNTS.get(name, 0) + n


class Records:
    """What one :func:`recording` block saw. ``spans`` in the order they
    opened (a span still open when the block ended has ``end_ns`` -1);
    ``counts[unit]`` each counter's increase over that unit, for the
    counters that moved."""

    def __init__(self) -> None:
        self._rows: List[list] = []
        self.counts: Dict[int, Dict[str, int]] = {}
        self._local = threading.local()
        self._unit = -1
        self._unit_stack: List[int] = []
        self._unit_counts: Dict[str, int] = {}

    @property
    def spans(self) -> List[Span]:
        return [Span(*row) for row in self._rows]

    def _thread(self):
        """This thread's stack of open spans and its native id."""
        local = self._local
        try:
            return local.stack, local.tid
        except AttributeError:
            local.stack, local.tid = [], threading.get_native_id()
            return local.stack, local.tid

    def _open(self, name: str) -> int:
        stack, tid = self._thread()
        if stack:
            parent = stack[-1]
            unit = self._rows[parent][4]
        elif self._unit_stack:
            parent = self._unit_stack[-1]
            unit = self._unit
        else:
            parent, unit = -1, self._unit + 1
            self._unit, self._unit_stack = unit, stack
            self._unit_counts = dict(COUNTS)
        index = len(self._rows)
        self._rows.append([name, time.perf_counter_ns(), -1, parent, unit,
                           tid])
        stack.append(index)
        return index

    def _close(self, index: int) -> None:
        row = self._rows[index]
        row[2] = time.perf_counter_ns()
        self._local.stack.pop()
        if row[3] == -1:
            before = self._unit_counts
            self.counts[row[4]] = {k: v - before.get(k, 0)
                                   for k, v in COUNTS.items()
                                   if v != before.get(k, 0)}
            self._unit_stack = []


class _Recorded:
    """A span while recording."""
    __slots__ = ("records", "name", "index")

    def __init__(self, records: Records, name: str):
        self.records, self.name = records, name

    def __enter__(self):
        self.index = self.records._open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        self.records._close(self.index)


class _Off:
    """The span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()
_RECORDS: Optional[Records] = None


def span(name: str):
    """The span ``name`` as a context manager."""
    if _RECORDS is None:
        return _OFF
    return _Recorded(_RECORDS, name)


@contextlib.contextmanager
def recording() -> Iterator[Records]:
    """Record every span and each unit's counter increases while the
    block runs; yields the :class:`Records`."""
    global _RECORDS
    if _RECORDS is not None:
        raise RuntimeError("spans are already being recorded")
    _RECORDS = Records()
    try:
        yield _RECORDS
    finally:
        _RECORDS = None
