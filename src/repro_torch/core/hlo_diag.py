"""Top-contributor diagnostics — the port of the reference package's
``repro.core.hlo_diag``.

    PYTHONPATH=src python -m repro_torch.core.hlo_diag <hlo.txt>

``top_bytes`` reuses ``hlo_stats``' exact charging rules over HLO text
but attributes per instruction, multiplied by loop trip counts, sorted
by total contribution, as the reference does. One difference in the
printout: its ``t_mem`` divides by the H100's HBM rate
(``H100.hbm_bw``), where the reference divides by the v5e's 819e9.

``top_ops`` gives the same table over the per-op records of a traced
eager step (:class:`repro_torch.core.roofline.TraceCounter`).
"""
from __future__ import annotations

import re
import sys
from typing import List, Tuple

from repro_torch.core import roofline as R
from repro_torch.core.hw import H100


def _trips(comps, entry):
    def trip_count(cond):
        consts = [int(c) for l in comps.get(cond, ())
                  for c in R._CONST_RE.findall(l)]
        return max(consts) if consts else 1

    trips = {entry: 1}
    stack = [entry]
    while stack:
        n0 = stack.pop()
        for line in comps.get(n0, ()):
            wm = R._WHILE_RE.search(line)
            if wm:
                cond = wm.group(1) or wm.group(4)
                body = wm.group(2) or wm.group(3)
                t = trips[n0] * (trip_count(cond) if cond else 1)
                if trips.get(body, 0) < t:
                    trips[body] = t
                    stack.append(body)
            else:
                om = R._OPCODE_RE.search(line)
                if om and om.group(1) in ("fusion", "call", "custom-call",
                                          "conditional"):
                    for cal in R._CALL_RE.findall(line):
                        if trips.get(cal, 0) < trips[n0]:
                            trips[cal] = trips[n0]
                            stack.append(cal)
    return trips


def top_bytes(hlo: str, n: int = 20) -> List[Tuple]:
    comps, entry = R._split_computations(hlo)
    shapes = {}
    internal = {}
    for cname, lines in comps.items():
        internal[cname] = set()
        for l in lines:
            m = R._RESULT_RE.match(l)
            if m:
                shapes[m.group(1)] = (m.group(2), m.group(3))
                om = R._OPCODE_RE.search(l)
                if om and om.group(1) not in ("parameter",
                                              "get-tuple-element",
                                              "constant"):
                    internal[cname].add(m.group(1))

    def nbytes_of(name):
        sh = shapes.get(name)
        if sh is None or sh[0] not in R._DTYPE_BYTES:
            return 0.0
        return R._shape_bytes(sh[0], sh[1])

    trips = _trips(comps, entry)
    VMEM = 128 * 2 ** 20
    rows = []
    for cname, lines in comps.items():
        t = trips.get(cname, 0)
        if not t:
            continue
        own = internal[cname]
        for line in lines:
            rm = R._RESULT_RE.match(line)
            om = R._OPCODE_RE.search(line)
            opcode = om.group(1) if om else ""
            if (not rm or not opcode or opcode in R._FREE_OPS
                    or opcode in R._EW_OPS):
                continue
            res_b = (R._shape_bytes(rm.group(2), rm.group(3))
                     if rm.group(2) in R._DTYPE_BYTES else 0.0)
            idx = line.find(opcode + "(")
            op_names = (R._OPERAND_RE.findall(
                line[idx + len(opcode) + 1:].split(")")[0])
                if idx >= 0 else [])
            in_loop = t > 4
            if in_loop:
                op_bytes = [0.0 if (nm in own and nbytes_of(nm) <= VMEM)
                            else nbytes_of(nm) for nm in op_names]
                if res_b <= VMEM and not line.startswith("ROOT"):
                    res_b = 0.0
            else:
                op_bytes = [nbytes_of(nm) for nm in op_names]
            iname = rm.group(1)
            if (opcode in ("dynamic-update-slice", "scatter")
                    or "dynamic-update-slice" in iname
                    or "scatter" in iname):
                b = 2.0 * sum(sorted(op_bytes)[:-1])
            elif (opcode in ("dynamic-slice", "slice", "gather")
                  or "dynamic-slice" in iname or "gather_fusion" in iname):
                b = 2.0 * res_b
            else:
                if opcode == "fusion":
                    callees = R._CALL_RE.findall(line)
                    body = comps.get(callees[0], []) if callees else []
                    if any("dynamic-slice" in bl for bl in body):
                        op_bytes = [min(ob, max(res_b, 1.0))
                                    for ob in op_bytes]
                b = res_b + sum(op_bytes)
            if b * t > 0:
                m = re.search(r'op_name="([^"]*)"', line)
                rows.append((b * t, t, b, opcode,
                             (m.group(1) if m else iname)[-80:]))
    rows.sort(reverse=True)
    return rows[:n]


def top_ops(records, n: int = 20) -> List[Tuple]:
    """``top_bytes``' table over traced records: (bytes × count, count,
    bytes per call, op, local input shapes), largest first."""
    rows = [(r.bytes * r.count, r.count, r.bytes, r.op, r.shapes[-80:])
            for r in records if r.bytes * r.count > 0]
    rows.sort(reverse=True)
    return rows[:n]


def main():
    path = sys.argv[1]
    hlo = open(path).read()
    rows = top_bytes(hlo)
    tot = sum(r[0] for r in rows)
    print(f"top-{len(rows)} bytes = {tot/1e12:.2f} TB "
          f"(t_mem {tot/H100.hbm_bw:.1f}s at the H100's "
          f"{H100.hbm_bw/1e12:.2f} TB/s HBM)")
    for r in rows:
        print(f"{r[0]/1e9:8.1f}GB trips={r[1]:5d} per={r[2]/1e9:6.2f}GB "
              f"{r[3]:14s} {r[4]}")


if __name__ == "__main__":
    main()
