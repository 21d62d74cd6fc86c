"""Host syncs a training step: the program's ``host_sync`` counter
(``repro_torch.telemetry``: each copy of a real tensor's values to the
host, where the host waits for the device) over each profiled step,
averaged. Read where the traced run recorded the program's spans
(``bench/program_spans.py``); 0 where steps were recorded and none
synced."""
from bench.program_spans import UNIT


def read(s, cell):
    p = getattr(s, "program", None)
    n = p.unit_count(UNIT["train"]) if p is not None else 0
    if not n:
        return None
    return sum(c.get("host_sync", 0) for name, _, c in p.units
               if name == UNIT["train"]) / n
