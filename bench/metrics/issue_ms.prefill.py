"""Milliseconds the host takes to issue a request's work: the mean
length, on the host's clock, of the program's ``step.prefill`` spans
recorded in the profiled sub-window (``bench/program_spans.py``). The
span ends when the last kernel is launched, not when it completes."""
from bench.program_spans import UNIT


def read(s, cell):
    p = getattr(s, "program", None)
    times = [t for name, t, _ in (p.units if p is not None else ())
             if name == UNIT["prefill"]]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
