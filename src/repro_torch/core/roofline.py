"""Roofline terms of a step, per device: the port of the reference
package's ``repro.core.roofline``, in two parts.

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

**The HLO-text analyser** (``hlo_stats``, ``collective_bytes``,
``RooflineReport``, ``analyze``) is the reference's, behaviour unchanged:
it reads an XLA HLO dump (for instance one the reference's dry run
wrote) with no jax. Its charging rules are the TPU's: elementwise ops
cost no HBM bytes and loop-body intermediates up to 128 MiB stay in
VMEM. ``analyze``'s default chip is the port's target, ``H100``; with
``chip=V5E`` it gives the reference's report field for field. Every
collective is charged at the island link (ICI) rate, as the reference
charges it.

**Its PyTorch counterpart** (``TraceCounter``, ``trace_stats``,
``analyze_trace``) counts one call of an eager step on DTensors under
``FakeTensorMode`` (no memory is allocated), below the DTensor layer,
so every number is one device's:

* FLOPs by the formulas of ``torch.utils.flop_counter`` on each op's
  local shards (compute that is replicated is counted on every device
  that does it; a checkpointed layer's recompute counts again);
* bytes as eager PyTorch moves them: the inputs and output of every op
  that is not a view or metadata op, each input by the elements it
  holds (a broadcast dimension once); a slice read or an in-place slice
  update moves only the slice, as in the HLO analyser. This
  deliberately differs from the HLO analyser's other rules: the TPU
  fuses elementwise chains into VMEM, and an eager step fuses nothing;
* each c10d functional collective (those DTensor issues to
  redistribute, and the explicit ones) once, by :func:`ring_traffic`
  over its group's size, its HBM side its wire bytes as in
  ``hlo_stats``.

``analyze_trace`` charges collectives at NVLink's rate
(``ici_link_bw · ici_links_per_axis``) and those over the ``pod`` mesh
axis at ``dcn_bw``, which the reference's docstring asks of its launcher.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import (FakeTensor, FakeTensorMode,
                                           unset_fake_temporarily)
from torch.utils._pytree import tree_leaves, tree_map, tree_map_only
from torch.utils.weak import WeakIdKeyDictionary
from torch.utils.flop_counter import (conv_flop_count, flop_registry,
                                      shape_wrapper)

from repro_torch.core.hw import H100, ChipSpec
from repro_torch.kernels import flash_attention_train as attn_train

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

_SHAPE_RE = re.compile(
    r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


_INSTR_RE = re.compile(
    r"=\s*(?:\(?)((?:" + "|".join(_DTYPE_BYTES) + r")\[[0-9,]*\])"
    r"[^=]*?\b(" + "|".join(_COLL_OPS) + r")(?:-start)?\(")
_GROUP_ITOA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUP_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _group_size(line: str) -> int:
    m = _GROUP_ITOA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUP_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 2


def _line_traffic(s: str):
    """(op, per-device ring traffic bytes) for one instruction line."""
    if re.search(r"\b(?:" + "|".join(_COLL_OPS) + r")-done", s):
        return None
    m = _INSTR_RE.search(s)
    if not m:
        return None
    shape_str, op = m.group(1), m.group(2)
    sm = _SHAPE_RE.search(shape_str)
    if not sm:
        return None
    r = _shape_bytes(sm.group(1), sm.group(2))
    n = _group_size(s)
    if n <= 1:
        return None
    return op, ring_traffic(op, r, n)


def ring_traffic(op: str, r: float, n: int) -> float:
    """Per-device ring traffic in bytes of one collective ``op`` (one of
    ``_COLL_OPS``) whose result is ``r`` bytes, over a group of ``n``
    ranks — the formula of HLO lines and of traced collectives alike."""
    if op == "all-reduce":
        return 2.0 * r * (n - 1) / n
    if op == "all-gather":
        return r * (n - 1) / n
    if op == "reduce-scatter":
        return r * (n - 1)
    if op == "all-to-all":
        return r * (n - 1) / n
    return r                                  # collective-permute


_COMP_HEAD_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*->")
_RESULT_RE = re.compile(r"^(?:ROOT )?%([\w.\-]+) = \(?(\w+)\[([0-9,]*)\]")
_OPCODE_RE = re.compile(r"=\s*[^=]*?\s([a-z][\w\-]*)\(")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_LHS_CDIM_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")

# opcodes whose "execution" moves no HBM bytes (layout/control plumbing)
_FREE_OPS = {"parameter", "constant", "tuple", "get-tuple-element",
             "bitcast", "while", "conditional", "after-all",
             "add-dependency", "iota", "partition-id", "replica-id"}

# standalone elementwise ops: the CPU backend leaves these unfused, but
# TPU XLA fuses elementwise chains into neighbors — charging each one
# separately would overstate the TPU memory term ~5-10x. They are
# charged ZERO; `fusion` call sites (already-fused groups) carry the
# traffic.
_EW_OPS = {"add", "subtract", "multiply", "divide", "select", "convert",
           "exponential", "exponential-minus-one", "tanh", "maximum",
           "minimum", "negate", "compare", "and", "or", "not", "xor",
           "rsqrt", "sqrt", "log", "log-plus-one", "power", "abs",
           "floor", "ceil", "clamp", "sign", "cosine", "sine",
           "is-finite", "round-nearest-afz", "broadcast", "reshape",
           "transpose", "reduce", "reduce-window", "map",
           "bitcast-convert", "real", "imag", "rem", "shift-left",
           "shift-right-logical", "shift-right-arithmetic", "pad",
           "concatenate", "reverse"}
_CALL_RE = re.compile(
    r"(?:condition|body|to_apply|calls)=%?([\w.\-]+)")
_WHILE_RE = re.compile(
    r"\bwhile\(.*?\),.*?(?:condition=%?([\w.\-]+)).*?(?:body=%?([\w.\-]+))"
    r"|\bwhile\(.*?\),.*?(?:body=%?([\w.\-]+)).*?(?:condition=%?([\w.\-]+))")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _split_computations(hlo_text: str):
    comps = {}
    entry = None
    cur = None
    for raw in hlo_text.splitlines():
        line = raw.rstrip()
        m = _COMP_HEAD_RE.match(line.strip())
        if m and line.endswith("{"):
            cur = m.group(2)
            comps[cur] = []
            if m.group(1):
                entry = cur
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            comps[cur].append(line.strip())
    if entry is None and comps:
        entry = list(comps)[-1]
    return comps, entry


def hlo_stats(hlo_text: str) -> Dict[str, float]:
    """Trip-count-aware HLO statistics: FLOPs (dot ops), HBM bytes
    (operands+results of non-free instructions), and per-device
    collective ring traffic. XLA's own cost_analysis counts while-loop
    bodies ONCE -- useless for scan-over-layers programs -- so this
    analyzer multiplies loop bodies by their trip count (parsed from the
    largest constant in the loop condition).

    Collective traffic per device follows the ring model documented in
    ``_line_traffic``.
    """
    comps, entry = _split_computations(hlo_text)

    shapes = {}
    internal = {}          # comp → names defined by real ops (not
    #                        parameter/gte/constant = loop-external data)
    for cname, lines in comps.items():
        internal[cname] = set()
        for l in lines:
            m = _RESULT_RE.match(l)
            if m:
                shapes[m.group(1)] = (m.group(2), m.group(3))
                om = _OPCODE_RE.search(l)
                if om and om.group(1) not in ("parameter",
                                              "get-tuple-element",
                                              "constant"):
                    internal[cname].add(m.group(1))

    def nbytes_of(name):
        sh = shapes.get(name)
        if sh is None or sh[0] not in _DTYPE_BYTES:
            return 0.0
        return _shape_bytes(sh[0], sh[1])

    def dims_of(name):
        sh = shapes.get(name)
        if sh is None:
            return None
        return [int(d) for d in sh[1].split(",") if d]

    def trip_count(cond_name):
        consts = [int(c) for l in comps.get(cond_name, ())
                  for c in _CONST_RE.findall(l)]
        return max(consts) if consts else 1

    memo = {}
    # VMEM residency: inside a hot loop body (lax.scan over layers /
    # flash blocks / CE chunks), intermediates PRODUCED AND CONSUMED in
    # the same iteration stay on-chip on TPU (fusion + VMEM-resident dot
    # operands), so tensors up to the 128 MiB VMEM defined by in-body
    # ops are not HBM traffic. Loop-carried state (parameters/gte) and
    # larger tensors still pay. This makes the memory term a
    # fused-execution estimate rather than an unfused upper bound.
    VMEM_RESIDENT = 128 * 2 ** 20

    def analyze_comp(name, stack=(), in_loop=False):
        key = (name, in_loop)
        if key in memo:
            return memo[key]
        if name in stack or name not in comps:
            return {}
        own = internal.get(name, set())
        acc = {"flops": 0.0, "bytes": 0.0}
        for line in comps[name]:
            rm = _RESULT_RE.match(line)
            om = _OPCODE_RE.search(line)
            opcode = om.group(1) if om else ""
            # --- collectives ---
            t = _line_traffic(line)
            if t:
                op, traffic = t
                # CPU-backend artifact corrections (TPU is the target):
                # 1. bf16 collectives are promoted/converted to f32 on
                #    CPU (f32 reduction, f32 dot operands); TPU moves
                #    bf16 on the wire → halve.
                if "promoted" in line:
                    traffic *= 0.5
                elif " f32[" in line[:64] or "= f32[" in line[:64]:
                    idx0 = line.find(op + "(")
                    inner0 = (line[idx0 + len(op) + 1:].split(")")[0]
                              if idx0 >= 0 else "")
                    if "convert" in inner0:
                        traffic *= 0.5
                # 2. CPU decomposes reduce-scatter into all-reduce +
                #    dynamic-slice; if this AR's uses are slices (or
                #    fusions that slice it), TPU emits a reduce-scatter
                #    → halve.
                if op == "all-reduce" and rm:
                    iname = rm.group(1)

                    def _slices(u):
                        if "dynamic-slice" in u or "slice" in u:
                            return True
                        if "fusion(" in u:
                            for cal in _CALL_RE.findall(u):
                                if any("dynamic-slice" in bl
                                       for bl in comps.get(cal, ())):
                                    return True
                        return False

                    uses = [u for u in comps[name]
                            if f"%{iname}" in u
                            and not u.startswith(f"%{iname} ")
                            and not u.startswith(f"ROOT %{iname} ")]
                    if uses and all(_slices(u) for u in uses):
                        traffic *= 0.5
                acc[op] = acc.get(op, 0.0) + traffic
                acc["count"] = acc.get("count", 0) + 1
                # HBM side of the collective = corrected wire bytes
                acc["bytes"] += traffic
                continue
            # --- flops: dot ---
            if opcode == "dot" and rm and rm.group(2) in _DTYPE_BYTES:
                res_elems = (_shape_bytes(rm.group(2), rm.group(3))
                             / _DTYPE_BYTES[rm.group(2)])
                k = 1
                cd = _LHS_CDIM_RE.search(line)
                idx = line.find("dot(")
                ops = _OPERAND_RE.findall(
                    line[idx + 4:].split(")")[0]) if idx >= 0 else []
                if ops and cd:
                    lhs_dims = dims_of(ops[0])
                    if lhs_dims:
                        for di in cd.group(1).split(","):
                            if di:
                                k *= lhs_dims[int(di)]
                acc["flops"] += 2.0 * res_elems * k
            # --- bytes ---
            if rm and opcode and opcode not in _FREE_OPS \
                    and opcode not in _EW_OPS:
                res_b = (_shape_bytes(rm.group(2), rm.group(3))
                         if rm.group(2) in _DTYPE_BYTES else 0.0)
                idx = line.find(opcode + "(")
                op_names = []
                if idx >= 0:
                    inner = line[idx + len(opcode) + 1:].split(")")[0]
                    op_names = _OPERAND_RE.findall(inner)
                if in_loop:
                    # VMEM residency: in-body intermediates ≤ threshold
                    # never reach HBM on TPU
                    op_bytes = [0.0 if (n in own
                                        and nbytes_of(n) <= VMEM_RESIDENT)
                                else nbytes_of(n) for n in op_names]
                    if (res_b <= VMEM_RESIDENT
                            and not line.startswith("ROOT")):
                        res_b = 0.0
                else:
                    op_bytes = [nbytes_of(n) for n in op_names]
                iname = rm.group(1)
                # in-place slice updates alias the big operand: charge
                # only the update slice (matches XLA cost semantics)
                if (opcode in ("dynamic-update-slice", "scatter")
                        or "dynamic-update-slice" in iname
                        or "scatter" in iname):
                    rest = sorted(op_bytes)[:-1] if op_bytes else []
                    b = 2.0 * sum(rest)
                # slicing reads only the slice, not the whole operand
                elif (opcode in ("dynamic-slice", "slice", "gather")
                      or "dynamic-slice" in iname
                      or "gather_fusion" in iname):
                    b = 2.0 * res_b
                else:
                    if opcode == "fusion":
                        # scan residuals: a fusion that dynamic-slices a
                        # big stacked operand reads only the slice
                        callees = _CALL_RE.findall(line)
                        body = comps.get(callees[0], []) if callees else []
                        if any("dynamic-slice" in bl for bl in body):
                            op_bytes = [min(ob, max(res_b, 1.0))
                                        for ob in op_bytes]
                    b = res_b + sum(op_bytes)
                # CPU-backend artifact: bf16 dot operands are converted
                # to f32 (and layout-copied in f32) on CPU; the TPU MXU
                # consumes bf16 directly → charge such f32 plumbing at
                # bf16 width. Detected by convert-fusions / copies with
                # f32 results feeding dot_generals.
                if (rm.group(2) == "f32"
                        and (("convert" in rm.group(1))
                             or (opcode == "copy"
                                 and "dot_general" in line))):
                    b *= 0.5
                acc["bytes"] += b
            # --- descend ---
            wm = _WHILE_RE.search(line)
            if wm:
                cond = wm.group(1) or wm.group(4)
                body = wm.group(2) or wm.group(3)
                n = trip_count(cond) if cond else 1
                sub = analyze_comp(body, stack + (name,),
                                   in_loop=(n > 4) or in_loop)
                for kk, v in sub.items():
                    acc[kk] = acc.get(kk, 0.0) + n * v
            elif opcode == "fusion":
                # fused body: count dot FLOPs inside; bytes are already
                # charged at the call site
                for callee in _CALL_RE.findall(line):
                    sub = analyze_comp(callee, stack + (name,), in_loop)
                    acc["flops"] += sub.get("flops", 0.0)
            elif opcode in ("call", "custom-call", "conditional"):
                for callee in _CALL_RE.findall(line):
                    sub = analyze_comp(callee, stack + (name,), in_loop)
                    for kk, v in sub.items():
                        acc[kk] = acc.get(kk, 0.0) + v
        memo[key] = acc
        return acc

    acc = analyze_comp(entry) if entry else {}
    out = {op: acc.get(op, 0.0) for op in _COLL_OPS}
    out["count"] = int(acc.get("count", 0))
    out["total"] = sum(out[op] for op in _COLL_OPS)
    out["flops"] = acc.get("flops", 0.0)
    out["bytes"] = acc.get("bytes", 0.0)
    return out


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    stats = hlo_stats(hlo_text)
    return {k: v for k, v in stats.items() if k not in ("flops", "bytes")}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float                 # per device
    hlo_bytes: float                 # per device
    coll_bytes: float                # per device
    coll_breakdown: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float               # 6·N_active·D global
    peak_bytes_per_device: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_bound(self) -> float:
        """Lower bound on step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global HLO flops) — remat/redundancy waste."""
        total = self.hlo_flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / max term — 1.0 means perfectly compute-bound."""
        b = self.step_time_bound
        return self.t_compute / b if b else 0.0

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},{self.n_chips},"
                f"{self.hlo_flops:.3e},{self.hlo_bytes:.3e},"
                f"{self.coll_bytes:.3e},{self.t_compute*1e3:.3f},"
                f"{self.t_memory*1e3:.3f},{self.t_collective*1e3:.3f},"
                f"{self.dominant},{self.useful_flops_ratio:.3f},"
                f"{self.roofline_fraction:.3f}")


HEADER = ("arch,shape,mesh,chips,hlo_flops/dev,hlo_bytes/dev,"
          "coll_bytes/dev,t_compute_ms,t_memory_ms,t_coll_ms,"
          "dominant,useful_flops_ratio,roofline_fraction")


def analyze(arch: str, shape: str, mesh_name: str, n_chips: int,
            cost: Dict[str, float], hlo_text: str, model_flops: float,
            chip: ChipSpec = H100,
            memory_stats: Optional[object] = None) -> RooflineReport:
    # NOTE: XLA's cost_analysis() counts while bodies ONCE (verified with
    # a scan-of-matmuls probe) — useless for scan-over-layers programs.
    # We use the trip-count-aware analyzer; `cost` is kept for
    # cross-checking in EXPERIMENTS.md §Dry-run.
    coll = hlo_stats(hlo_text)
    flops = coll["flops"]
    byts = coll["bytes"]
    # ICI vs DCN: inter-pod collectives (axis `pod`) are tagged by the
    # launcher via mesh_name; the conservative charge here uses ICI for
    # all (DCN correction applied by the launcher when pod axis is used).
    ici_bw = chip.ici_link_bw * chip.ici_links_per_axis
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=coll["total"],
        coll_breakdown=coll,
        t_compute=flops / chip.peak_flops_bf16,
        t_memory=byts / chip.hbm_bw,
        t_collective=coll["total"] / ici_bw,
        model_flops=model_flops,
    )
    if memory_stats is not None:
        try:
            rep.peak_bytes_per_device = float(
                memory_stats.temp_size_in_bytes
                + memory_stats.argument_size_in_bytes
                + memory_stats.output_size_in_bytes)
        except Exception:
            pass
    return rep


# --------------------------------------------------------------------------
# the PyTorch counterpart: one eager step traced under FakeTensorMode
# --------------------------------------------------------------------------

#: c10d functional collectives by the HLO opcode each stands for
_TRACED_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

#: in-place updates of a slice of their first argument: they move the
#: update, read and written, not the whole buffer (the HLO analyser's
#: rule for dynamic-update-slice and scatter)
_UPDATE_TRACED = {"index_put_", "_index_put_impl_", "index_copy_",
                  "index_add_", "scatter_", "scatter_add_",
                  "masked_scatter_"}
#: reads of a slice: they move what they return, read and written (its
#: rule for dynamic-slice and gather)
_SLICE_TRACED = {"index", "gather", "index_select", "take_along_dim"}

#: allocations without a write: their values are not known
_UNWRITTEN = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "resize_"}

#: ops that move no bytes: allocation without a write, aliasing,
#: bookkeeping and waits (views are told by their schema)
_FREE_TRACED = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided", "detach", "alias", "lift_fresh",
                "_unsafe_view", "wait_tensor", "_local_scalar_dense",
                "sym_size", "sym_stride", "sym_numel",
                "sym_storage_offset", "resize_"}


def bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """A batched product's FLOPs (2·b·m·n·k), under any overload:
    ``bmm.dtype`` (``out_dtype=``, the bf16 score products on the card)
    passes its dtype positionally, where torch 2.11's own formula takes
    it for ``out_shape`` and raises. Give it to ``FlopCounterMode`` in
    its ``custom_mapping`` (:data:`CUSTOM_FLOPS`)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        groups, output_mask, out_shape=None, **_) -> int:
    """A convolution's backward FLOPs: torch's formula with its weight
    gradient divided by ``groups``. torch counts that term as if every
    input channel met every output channel, which for the SSM's
    depthwise conv (``groups`` = channels) is ``channels`` times the
    work. Give it to ``FlopCounterMode`` beside :func:`bmm_flops`
    (:data:`CUSTOM_FLOPS`)."""
    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])

    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape, out_shape[0],
                                 not transposed)
    if output_mask[1]:
        a, b = ((grad_out_shape, x_shape) if transposed
                else (x_shape, grad_out_shape))
        flops += conv_flop_count(t(a), t(b), t(out_shape[1])) // groups
    return flops


#: the formulas that replace torch's, and those of the port's own
#: operators (the training attention's kernels), as ``FlopCounterMode``'s
#: ``custom_mapping`` takes them
CUSTOM_FLOPS = {torch.ops.aten.bmm: bmm_flops,
                torch.ops.aten.convolution_backward: conv_backward_flops,
                torch.ops.repro_torch.attn_train_fwd: attn_train.forward_flops,
                torch.ops.repro_torch.attn_train_bwd:
                    attn_train.backward_flops}
#: torch's FLOP formulas by op, with :data:`CUSTOM_FLOPS` in their place
FLOP_FORMULAS = {**flop_registry, **{op: shape_wrapper(f)
                                     for op, f in CUSTOM_FLOPS.items()}}


@dataclasses.dataclass
class OpRecord:
    """One traced op at one set of local input shapes: its calls, and
    per call its FLOPs, its bytes and (a collective) its opcode, ring
    traffic and mesh axis."""
    op: str
    shapes: str
    count: int
    flops: float
    bytes: float
    collective: Optional[str] = None
    traffic: float = 0.0
    axis: Optional[str] = None


def _held_bytes(t) -> int:
    """Bytes of the elements ``t`` holds: a broadcast (stride 0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_view(func) -> bool:
    if func.is_view:
        return True
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


#: integer and boolean dtypes, whose values a trace carries
_VALUE_DTYPES = {torch.bool, torch.uint8, torch.int8, torch.int16,
                 torch.int32, torch.int64}
#: the most elements of a tensor whose values a trace carries
VALUE_NUMEL = 1 << 22


class TraceCounter(FakeTensorMode):
    """A ``FakeTensorMode`` that records every op it runs while
    :attr:`counting`: an op on DTensors reaches it only as the ops on
    their local shards, so each record is one device's. Nested
    dispatches (the mode's own decompositions) are not counted again.
    ``mesh`` names the axis of each collective's group.

    It also carries the values of small integer and boolean tensors
    (positions, block bounds, cache slots) that follow from known ones,
    for the host decisions a step makes from them (:meth:`values_of`).
    An ``aten`` op gets values for its outputs when all of them are
    such tensors of at most :data:`VALUE_NUMEL` elements, none more
    than twice its tensor inputs' together (a view excepted), and every
    input's values are known: it is run once more on those values on
    the host. So creation ops (``arange``, ``full``) start a chain, an
    op that broadcasts into a larger tensor (an outer difference of
    positions) ends it, and so
    do allocations without a write, random ops and collectives (what
    another rank sends is not known to rank 0). An op that writes into
    a tensor from unknown values makes the tensor's values unknown."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.counting = False
        self._records: Dict[tuple, OpRecord] = {}
        self._depth = 0
        self._axes: Optional[Dict[str, str]] = None
        self._values = WeakIdKeyDictionary()

    @property
    def records(self) -> list:
        return list(self._records.values())

    def values_of(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """``t``'s values on the host, if this trace knows them: a real
        tensor's own, or those carried for a fake one; else ``None``."""
        if not isinstance(t, FakeTensor):
            return t.cpu()
        return self._values.get(t)

    def from_tensor(self, tensor, *args, **kwargs):
        fake = super().from_tensor(tensor, *args, **kwargs)
        if (not isinstance(tensor, FakeTensor) and tensor.dtype in
                _VALUE_DTYPES and tensor.numel() <= VALUE_NUMEL):
            self._values[fake] = tensor.detach().cpu()
        return fake

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        top = self._depth == 0
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if top and out is not NotImplemented:
            self._carry_values(func, args, kwargs or {}, out)
            if self.counting:
                self._record(func, args, kwargs or {}, out)
        return out

    def _carry_values(self, func, args, kwargs, out) -> None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or any(t.dtype not in _VALUE_DTYPES
                           or t.numel() > VALUE_NUMEL for t in outs):
            return self._forget_written(func, args, kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        known = [self.values_of(t) for t in ins]
        if (func.namespace != "aten"
                or func.overloadpacket.__name__ in _UNWRITTEN
                or torch.Tag.nondeterministic_seeded in func.tags
                or any(v is None for v in known)
                or (ins and not _is_view(func)
                    and sum(t.numel() for t in outs)
                    > 2 * sum(t.numel() for t in ins))):
            return self._forget_written(func, args, kwargs)
        on_host = dict(zip(map(id, ins), known))

        def host(x):
            if isinstance(x, torch.Tensor):
                return on_host[id(x)]
            return torch.device("cpu") if isinstance(x, torch.device) else x

        with unset_fake_temporarily():
            got = func(*tree_map(host, args), **tree_map(host, kwargs))
        for t, v in zip(outs, (v for v in tree_leaves(got)
                               if isinstance(v, torch.Tensor))):
            self._values[t] = v

    def _forget_written(self, func, args, kwargs) -> None:
        if not func._schema.is_mutable:
            return
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                x = args[i] if i < len(args) else kwargs.get(a.name)
                for t in tree_leaves(x):
                    if isinstance(t, torch.Tensor):
                        self._values.pop(t, None)

    def _axis(self, group_name: str) -> Optional[str]:
        if self.mesh is None:
            return None
        if self._axes is None:
            self._axes = {self.mesh.get_group(i).group_name: name
                          for i, name in enumerate(self.mesh.mesh_dim_names)}
        return self._axes.get(group_name)

    def _record(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if (func.namespace == "prim" or name in _FREE_TRACED
                or _is_view(func)):
            return
        ins = [t for t in tree_leaves((args, {k: v for k, v in
                                              kwargs.items() if k != "out"}))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        coll = (_TRACED_COLLECTIVES.get(name)
                if func.namespace in _COLLECTIVE_NAMESPACES else None)
        traffic, axis = 0.0, None
        if coll is not None:
            group = [a for a in args if isinstance(a, str)][-1]
            n = dist.distributed_c10d._resolve_process_group(group).size()
            if n > 1:
                traffic = ring_traffic(coll, sum(map(_held_bytes, outs)), n)
                axis = self._axis(group)
            else:
                coll = None
        if coll is not None:
            flops, nbytes = 0.0, traffic
        else:
            pk = func.overloadpacket
            flops = (float(FLOP_FORMULAS[pk](*args, **kwargs, out_val=out))
                     if pk in FLOP_FORMULAS else 0.0)
            if name.startswith("new_") or name.endswith("_like"):
                nbytes = float(sum(map(_held_bytes, outs)))   # writes only
            elif name in _UPDATE_TRACED:
                nbytes = 2.0 * sum(map(_held_bytes, ins[1:]))
            elif name in _SLICE_TRACED:
                nbytes = 2.0 * sum(map(_held_bytes, outs))
            else:
                nbytes = float(sum(map(_held_bytes, ins))
                               + sum(map(_held_bytes, outs)))
        shapes = ",".join(str(tuple(t.shape)) for t in ins)
        key = (str(func), shapes)
        rec = self._records.get(key)
        if rec is None:
            self._records[key] = OpRecord(str(func), shapes, 1, flops, nbytes,
                                          coll, traffic, axis)
        else:
            rec.count += 1

    def stats(self) -> Dict[str, float]:
        """The keys of :func:`hlo_stats`, summed over the records."""
        out = {op: 0.0 for op in _COLL_OPS}
        flops = nbytes = 0.0
        count = 0
        for r in self._records.values():
            flops += r.flops * r.count
            nbytes += r.bytes * r.count
            if r.collective is not None:
                out[r.collective] += r.traffic * r.count
                count += r.count
        out["count"] = count
        out["total"] = sum(out[op] for op in _COLL_OPS)
        out["flops"] = flops
        out["bytes"] = nbytes
        return out

    def traffic_by_axis(self) -> Dict[Optional[str], float]:
        """Collective traffic per device by mesh axis."""
        out: Dict[Optional[str], float] = {}
        for r in self._records.values():
            if r.collective is not None:
                out[r.axis] = out.get(r.axis, 0.0) + r.traffic * r.count
        return out


def _counter_of(tree) -> Optional[TraceCounter]:
    """The TraceCounter that made a fake tensor of ``tree`` (DTensors
    looked into), if any."""
    for t in tree_leaves(tree):
        t = getattr(t, "_local_tensor", t)
        if isinstance(t, FakeTensor) and isinstance(t.fake_mode,
                                                    TraceCounter):
            return t.fake_mode
    return None


def trace_stats(step: Callable, *args, **kwargs) -> Dict[str, float]:
    """The keys of :func:`hlo_stats` — ``flops``, ``bytes``, the five
    collective kinds, ``count`` and ``total`` — per device, for one call
    ``step(*args, **kwargs)``. Arguments made under a
    :class:`TraceCounter` are traced in it (its records are this call's
    afterwards); real tensors are turned into fake ones of a new
    counter. Nothing is allocated."""
    counter = _counter_of((args, kwargs))
    if counter is None:
        counter = TraceCounter()
        args, kwargs = tree_map_only(torch.Tensor, counter.from_tensor,
                                     (args, kwargs))
    counter._records.clear()
    with counter, _quiet_propagation(counter):
        counter.counting = True
        try:
            step(*args, **kwargs)
        finally:
            counter.counting = False
    return counter.stats()


@contextlib.contextmanager
def _quiet_propagation(counter: TraceCounter):
    """DTensor learns a new op's output shape by running the op once on
    global-shape fake arguments, in the fake mode it detects — the
    counter's own, on an autograd thread. Within the block that run
    happens with every dispatch mode set aside (so in a fake mode of its
    own, unseen by the counter and by a MemTracker entered around it)
    and uncounted. The hook is DTensor's private
    ``ShardingPropagator._propagate_tensor_meta_non_cached`` (torch 2.11
    to 2.13); without it nothing is set aside."""
    from torch.utils._python_dispatch import _disable_current_modes
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        original = ShardingPropagator._propagate_tensor_meta_non_cached
    except (ImportError, AttributeError):
        yield
        return

    def quiet(self, op_schema):
        counting, counter.counting = counter.counting, False
        try:
            with _disable_current_modes():
                return original(self, op_schema)
        finally:
            counter.counting = counting

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = original


def analyze_trace(arch: str, shape: str, mesh_name: str, n_chips: int,
                  stats: Dict[str, float], model_flops: float,
                  chip: ChipSpec = H100, dcn_traffic: float = 0.0,
                  peak_bytes: Optional[float] = None) -> RooflineReport:
    """A :class:`RooflineReport` from :func:`trace_stats`' dict against
    ``chip``: collectives at the island link's rate (NVLink,
    ``ici_link_bw · ici_links_per_axis``), except ``dcn_traffic`` of
    them (the ``pod`` axis) at ``dcn_bw``. The two run on separate
    links, so the collective term is the larger of the two times."""
    ici_bw = chip.ici_link_bw * chip.ici_links_per_axis
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=stats["flops"], hlo_bytes=stats["bytes"],
        coll_bytes=stats["total"], coll_breakdown=stats,
        t_compute=stats["flops"] / chip.peak_flops_bf16,
        t_memory=stats["bytes"] / chip.hbm_bw,
        t_collective=max((stats["total"] - dcn_traffic) / ici_bw,
                         dcn_traffic / chip.dcn_bw),
        model_flops=model_flops, peak_bytes_per_device=peak_bytes)
