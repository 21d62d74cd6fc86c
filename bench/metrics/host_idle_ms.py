"""Milliseconds a step or request that the device sat idle waiting on
the program's host code, for ``host_idle_ms.<kind>``: the profiled
sub-window's idle gaps put down to a program span (the span in which the
host launched the operation that ends the gap, ``bench/program_spans.
py``), over the step or request spans recorded inside it."""
from bench.program_spans import UNIT


def read(s, cell):
    p = getattr(s, "program", None)
    n = p.unit_count(UNIT[cell.kind]) if p is not None else 0
    if not n:
        return None
    return 1e3 * p.host_idle_s / n
