"""Shared by ``tests/test_torch_dryrun_held_{train,prefill,decode}.py``,
``tests/test_torch_dryrun_baseline_{train,prefill,decode}.py``,
``tests/test_torch_dryrun_held_multipod.py`` and
``tests/test_torch_dryrun_fsdp_cp_{dense,families,multipod}.py`` (no
tests of its own):
every cell of the dry run's sweep — each architecture of
``list_archs()`` at each of its shapes — traced on the 16 x 16
production mesh at full width and 1 layer (jamba one period of 8), held
to the reference's own dry run of the same cell.

A cell is ``(arch, shape, layers, *modes)``: no mode is the default
mapping on 16 x 16, ``"baseline"`` the paper-faithful mapping
(``lower_cell(..., baseline=True)``: no ``act_spec``/``qkv_spec``, no
FSDP, no ZeRO-1, the MoE under ``gather``), ``"multi"`` the
2 x 16 x 16 mesh with axes ``("pod", "data", "model")`` and
``"fsdp_cp"`` ``--mapping fsdp_cp`` (train: no tensor parallelism, the
sequence over ``model``, ZeRO-3 over both axes; held by
``tests/test_torch_dryrun_fsdp_cp_{dense,families,multipod}.py``).

The reference's counts come from one child python per file,
``tests/test_torch_dryrun_ref.py --production <out.json>
<arch>:<shape>:<layers>[:baseline][:multi][:fsdp_cp] ...``, run by a
module-scoped fixture. The
port's come from ``repro_torch.launch.dryrun.lower_cell(...,
device="cpu")``, its memory untracked. Both are per device. bert_large and
bert_exlarge are one cell at one layer: each side traces it once.

Bars, as deviation (b) holds the blockwise attention:

* FLOPs. The port's no-skip count — its count as run plus the FLOPs of
  the block pairs ``flash_torch`` skipped, taken from the spy of
  ``tests/test_torch_dryrun.py`` in the same trace — within 10 % of the
  reference's, two-sided. Where the reference does work that the port
  does not, the gap is held exactly to its cause (:data:`CAUSES`): the
  port's own products of that kind equal their formula, the
  reference's, read from its HLO by the dots' shapes, equal their
  stated multiple of the port's, and what is left of each side once
  they are taken out is held within 10 %.
* Collective bytes: at most 10 % over the reference's; for a cell of
  :data:`COMBINED`, over the reference's with every operand of its
  combined collectives counted (its own count reads one of each).
"""
import dataclasses
import itertools
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun as dr
import test_torch_dryrun_ref as ref
import test_torch_ranks as ranks
from repro_torch.configs.base import (SHAPES, arch_shapes, get_config,
                                      list_archs)
from repro_torch.launch import dryrun as D

CLOSE = 0.10
#: the production mesh's (data, model) sizes (data: the batch's shards
#: on 16 x 16; ``pod`` doubles them on 2 x 16 x 16, :func:`data_of`),
#: and the reference's cross-entropy chunk
DATA, MODEL, CE_CHUNK = 16, 16, 512


def data_of(modes):
    """The batch's shards of a cell's mesh: ``data``, times ``pod``'s 2
    on the multi-pod mesh."""
    return DATA * (2 if "multi" in modes else 1)


def layers_of(arch):
    """The depth of a held cell: one layer, the hybrid one period."""
    cfg = get_config(arch)
    return cfg.hybrid_period or 1


def cells(kind, *modes):
    """(arch, shape, layers, *modes) of every sweep cell whose shape is
    of ``kind`` (train, prefill, or decode: decode_32k and long_500k)."""
    return [(a, s.name, layers_of(a), *modes) for a in list_archs()
            for s in arch_shapes(get_config(a)) if s.kind == kind]


#: the hybrid's train cell (one period of 8 layers), the costliest cell
#: to lower on both sides (~70 s on one core): held by the decode file,
#: so that each of the three files takes under 300 s on one core
MOVED = ("jamba_v0_1_52b", "train_4k", 8)


def file_cells(name):
    """The cells that the file ``tests/test_torch_dryrun_held_<name>.py``
    holds: those of its kind, :data:`MOVED` in the decode file."""
    out = [c for c in cells(name) if c != MOVED]
    return out + [MOVED] if name == "decode" else out


#: the ``fsdp_cp`` files' train cells (16 x 16, or 2 x 16 x 16 for
#: ``multipod``), split so that each file's reference fixture lowers in
#: about 90 s on one core or less
FSDP_CP_FAMILIES = ("dbrx_132b", "qwen3_moe_30b_a3b", "jamba_v0_1_52b",
                    "mamba2_2_7b", "t5_large", "whisper_tiny")
FSDP_CP_MULTIPOD = ("h2o_danube_1_8b", "qwen2_vl_72b", "qwen3_moe_30b_a3b",
                    "mamba2_2_7b")


def fsdp_cp_cells(name):
    """The train cells of ``tests/test_torch_dryrun_fsdp_cp_<name>.py``
    (``dense``, ``families`` or ``multipod``), with their modes."""
    if name == "multipod":
        return [c for c in cells("train", "multi", "fsdp_cp")
                if c[0] in FSDP_CP_MULTIPOD]
    return [c for c in cells("train", "fsdp_cp")
            if (c[0] in FSDP_CP_FAMILIES) == (name == "families")]


def params(cells_):
    """pytest params of ``cells_`` (arch, shape, layers), the modes left
    out of the ids."""
    return [pytest.param(*c[:3], id="-".join(map(str, c[:3])))
            for c in cells_]


def _lower_reference(cells_, out, timeout=None):
    """The reference's counts of ``cells_`` by cell name, from one child
    python writing ``out``."""
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(ref.__file__)), "--production",
         str(out)] + [":".join(map(str, c)) for c in cells_],
        capture_output=True, text=True, timeout=timeout,
        env=ranks.child_env(JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(pathlib.Path(out).read_text())


def reference_fixture(name, cells_=None):
    """A module-scoped fixture: the reference's ``hlo_stats`` of
    ``cells_`` (default ``file_cells(name)``) by cell name
    (``test_torch_dryrun_ref.cell_key``), from one child python (run
    before the port traces: on one core the two would only share it)."""
    @pytest.fixture(scope="module")
    def reference(tmp_path_factory):
        out = tmp_path_factory.mktemp(f"held_{name}") / "ref.json"
        return _lower_reference(file_cells(name) if cells_ is None
                                else cells_, out, timeout=900)
    return reference


def _operands(r):
    """The shapes of a traced record's first two operands."""
    return [tuple(map(int, t.strip("()").split(", ")))
            for t in r.shapes.split("),(")[:2]]


def _product_flops(records, *mkn):
    """FLOPs of the traced ``aten.mm`` calls (m, k) x (k, n) at each of
    the (m, k, n) of ``mkn``."""
    def shape(r):
        a, b = _operands(r)
        return a[0], a[1], b[1]
    return sum(r.flops * r.count for r in records
               if r.op == "aten.mm.default" and shape(r) in mkn)


def _ref_dots(dots, keep):
    """The reference's dot FLOPs of the dots whose (result, lhs, rhs)
    dims tuples pass ``keep``."""
    return sum(f for key, f in dots.items()
               if keep(*(tuple(int(d) for d in part.split(",") if d)
                         for part in key.split("|"))))


def _head_rows(records, dots, cfg, shape, modes=(), skipped=0.0):
    """A train cell whose vocabulary ``model`` does not divide: the
    port's head multiplies each rank's rows once (its rows of the
    sequence, split over ``model``, by the whole head: forward, and the
    gradients of x and of the head). The reference's XLA splits each
    512-row chunk of the loss's scan over only the ranks that hold its
    rows, so each rank computes every chunk's share: ``S / 512`` times
    the port's rows. Holds the port's three head products to their
    formula and the reference's, read from its HLO (every dot with the
    vocabulary among its dims), to ``S / 512`` times the port's, both
    exactly; returns (the port's, the reference's)."""
    seq = SHAPES[shape].seq_len // (2 if cfg.enc_dec else 1)
    rows = SHAPES[shape].global_batch // data_of(modes) * (seq // MODEL)
    d, v = cfg.d_model, cfg.vocab
    # the forward, x's gradient, and the head's in either layout
    # (a tied head is the table's transpose)
    head = _product_flops(records, (rows, d, v), (rows, v, d), (d, rows, v),
                          (v, rows, d))
    assert head == 3 * 2 * rows * d * v, (head, rows)
    # the reference's: every dot of the vocabulary, the rows and d alone
    # (jamba's router, (T / data, d) x (d, E), has a vocabulary's 65536
    # rows)
    want = _ref_dots(dots, lambda *dims: any(v in t for t in dims) and all(
        x in (rows, d, v) for t in dims for x in t))
    assert want == pytest.approx(seq // CE_CHUNK * head, rel=1e-12), (
        want, head)
    return head, want


def _whole_down(records, dots, cfg, shape, modes=(), skipped=0.0):
    """The hybrid's prefill: the port splits the dense FFN over
    ``model`` (Megatron's column- and row-parallel products). The
    reference's XLA splits its up and gate products by rows and runs the
    down product whole on every rank: ``model`` times the port's. Holds
    the port's down products to their formula and the reference's, read
    from its HLO ((rows, d_ff) x (d_ff, d) at the whole d_ff), to
    ``model`` times the port's, both exactly; returns (the port's, the
    reference's)."""
    from repro_torch.models.lm import hybrid_ssm_split
    rows = SHAPES[shape].global_batch // data_of(modes) * \
        SHAPES[shape].seq_len
    f, d = cfg.d_ff // MODEL, cfg.d_model
    n_dense = hybrid_ssm_split(cfg)[1] * (cfg.n_layers // cfg.hybrid_period)
    down = _product_flops(records, (rows, f, d))
    assert down == n_dense * 2 * rows * f * d, (down, n_dense)
    want = _ref_dots(dots, lambda res, lhs, rhs: (
        lhs == (rows, cfg.d_ff) and rhs == (cfg.d_ff, d)))
    assert want == pytest.approx(MODEL * down, rel=1e-12), (want, down)
    return down, want


def _whole_ffn(records, dots, cfg, shape, modes=(), skipped=0.0):
    """The hybrid under ``--baseline``: the port splits the dense FFN
    over ``model`` (:func:`repro_torch.models.lm._model_split_ffn`,
    Megatron's column- and row-parallel products). Its weights sit in a
    (period, layer) stack that the positional rule leaves whole on
    ``model``, and with no spec to split the rows the reference's XLA
    runs all three products whole on every rank: ``model`` times the
    port's. Holds the port's products (rows, d) x (d, d_ff / model) and
    (rows, d_ff / model) x (d_ff / model, d), each layout, to their
    formula — 3 a dense layer in prefill; in train 12 (forward,
    recompute, the two gradients of each), less the period's last down
    product, which the checkpoint's recompute does not rerun (it stops
    once the backward has every tensor it saved) — and the reference's,
    read from its HLO (every dot with the whole d_ff and the rows among
    its dims), to ``model`` times the port's 3 or 12 a layer; returns
    (the port's, the reference's)."""
    from repro_torch.models.lm import hybrid_ssm_split
    rows = SHAPES[shape].global_batch // data_of(modes) * \
        SHAPES[shape].seq_len
    f, d = cfg.d_ff // MODEL, cfg.d_model
    n_dense = hybrid_ssm_split(cfg)[1] * (cfg.n_layers // cfg.hybrid_period)
    unit = 2 * rows * f * d
    each = list(itertools.permutations((rows, f, d)))
    port = _product_flops(records, *each)
    n = {"prefill": 3, "train": 12}[SHAPES[shape].kind]
    rerun = 1 if SHAPES[shape].kind == "train" else 0
    assert port == (n * n_dense - rerun) * unit, (port / unit, n_dense)
    want = _ref_dots(dots, lambda *dims: (any(cfg.d_ff in t for t in dims)
                                          and any(rows in t for t in dims)))
    assert want == pytest.approx(MODEL * n * n_dense * unit, rel=1e-12), (
        want / unit, n_dense)
    return port, want


def _pod_ffn(records, dots, cfg, shape, modes=(), skipped=0.0):
    """The hybrid's decode on 2 x 16 x 16: the port computes its dense
    FFN (whole weights, as XLA keeps them in decode) on each rank's rows
    of the batch, split over ``("pod", "data")``. The reference's XLA
    splits those rows over ``data`` only and repeats them over ``pod``:
    twice the port's. Holds the port's products (rows, d) x (d, d_ff)
    and (rows, d_ff) x (d_ff, d), 3 a dense layer, to their formula and
    the reference's, read from its HLO (the same products at twice the
    rows), to twice the port's, both exactly; returns (the port's, the
    reference's)."""
    from repro_torch.models.lm import hybrid_ssm_split
    rows = SHAPES[shape].global_batch // data_of(modes)
    d, f = cfg.d_model, cfg.d_ff
    n_dense = hybrid_ssm_split(cfg)[1] * (cfg.n_layers // cfg.hybrid_period)
    port = _product_flops(records, (rows, d, f), (rows, f, d))
    assert port == n_dense * 3 * 2 * rows * d * f, (port, n_dense)
    want = _ref_dots(dots, lambda res, lhs, rhs: lhs in (
        (2 * rows, d), (2 * rows, f)) and rhs in ((d, f), (f, d)))
    assert want == pytest.approx(2 * port, rel=1e-12), (want, port)
    return port, want


#: the reference's attention products under ``--mapping fsdp_cp`` over
#: the port's, by head layout (grouped KV heads, or one KV head a query
#: head). The port runs 9 products a block pair, each rank's S / model
#: queries against all S keys: QKᵀ and PV forward, again in the
#: recompute, then QKᵀ, dV, dP, dQ and dK. The reference's XLA runs
#: every pair of the flash scans' 8 query blocks and 4 key blocks on
#: every rank of ``model``, on a share of each block that the 16 ranks
#: overlap (its HLO, h2o and gpt2 train_4k, the dots' block shapes
#: times their loops' trip counts of 8 and 4): with grouped KV heads
#: 256 queries of a 512-row block against 512 keys in QKᵀ and dP, all
#: 1024 of the block in PV and dQ, and 256 in dV and dK — 22 units of
#: 256 x 256 a pair, 44 port products in all; with one KV head a query
#: head all 512 queries against 256 keys in QKᵀ, dP, dV and dK and 256
#: against 256 in PV and dQ — 30 port products
CP_ATTENTION = {True: 44 / 9, False: 30 / 9}


def _cp_attention(records, dots, cfg, shape, modes=(), skipped=0.0):
    """Attention under ``--mapping fsdp_cp`` (:data:`CP_ATTENTION`).
    Holds the port's block products, as traced plus the pairs
    ``flash_torch`` skipped, to 9 products of one rank's queries against
    all keys (its rows of the batch, every query head, S / model
    queries, all S keys), and the reference's, read from its HLO (every
    4-dimensional dot over the rank's batch and heads), to their
    multiple of the port's, both exactly; returns (the port's, the
    reference's)."""
    seq = SHAPES[shape].seq_len
    b, h, hd = SHAPES[shape].global_batch // data_of(modes), \
        cfg.n_heads, cfg.head_dim
    unit = 2 * b * h * (seq // MODEL) * seq * hd
    # a hybrid's period holds one attention layer
    n_layers = cfg.n_layers // (cfg.hybrid_period or 1)

    def attention(r):
        if r.op not in ("aten.bmm.default", "aten.baddbmm.default"):
            return False
        a, w = _operands(r)
        return a[0] == b * h and hd in a[1:] + w[1:]
    port = sum(r.flops * r.count for r in records if attention(r)) + skipped
    assert port == 9 * n_layers * unit, (port / unit, n_layers)
    want = _ref_dots(dots, lambda *dims: all(
        len(t) == 4 and t[:2] == (b, h) for t in dims))
    mult = CP_ATTENTION[cfg.n_kv_heads < cfg.n_heads]
    assert want == pytest.approx(mult * port, rel=1e-12), (want / port,
                                                          mult)
    return port, want


def _router_rows(records, dots, cfg, shape, modes=(), skipped=0.0):
    """The MoE's router under ``--mapping fsdp_cp``: the port routes
    each rank's tokens (its rows of the batch, S / model positions of
    each), in fp32: the forward, its recompute and the two gradients.
    The reference's XLA runs the router on the tokens split over
    ``data`` alone, each rank all S positions: ``model`` times the
    port's rows. Holds the port's four products to their formula and
    the reference's, read from its HLO (every dot over (rows, d, E) at
    its rows), to ``model`` times the port's, both exactly; returns
    (the port's, the reference's)."""
    seq = SHAPES[shape].seq_len
    rows = SHAPES[shape].global_batch // data_of(modes) * (seq // MODEL)
    d, e = cfg.d_model, cfg.moe.n_experts
    n_moe = _n_moe_layers(cfg)
    port = _product_flops(records, (rows, d, e), (rows, e, d), (d, rows, e))
    assert port == 4 * n_moe * 2 * rows * d * e, (port, n_moe)
    # (jamba's head, (rows, d) x (d, V), has 65536 = model x rows
    # columns: a router's dot names E)
    want = _ref_dots(dots, lambda *dims: all(
        set(t) <= {MODEL * rows, d, e} for t in dims) and any(
            MODEL * rows in t for t in dims) and any(e in t for t in dims))
    assert want == pytest.approx(MODEL * port, rel=1e-12), (want, port)
    return port, want


def _pod_experts(records, dots, cfg, shape, modes=(), skipped=0.0):
    """The MoE's experts under ``--mapping fsdp_cp`` on 2 x 16 x 16: the
    port splits every expert's C capacity slots over the 512 ranks that
    split the tokens (``moe._gather_on_slots``) and multiplies each
    rank's C / 512 slots by the whole weights: 12 products a layer (3
    forward, 3 in the recompute, 2 gradients of each). The reference's
    XLA multiplies all C slots by the weights' ZeRO-3 shard, which
    ``pod`` does not split (``fsdp_axes=("data", "model")``): each pod
    repeats the work, twice the port's. Holds the port's expert products
    to their formula and the reference's, read from its HLO (every
    3-dimensional dot over the E experts with the whole capacity among
    its dims), to twice the port's, both exactly; returns (the port's,
    the reference's)."""
    from repro_torch.models.moe import capacity
    m = cfg.moe
    cap = capacity(SHAPES[shape].global_batch * SHAPES[shape].seq_len, m)
    slots = -(-cap // (data_of(modes) * MODEL))
    e, d, f = m.n_experts, cfg.d_model, m.d_ff_expert

    def expert(r):
        if r.op != "aten.bmm.default":
            return False
        a, w = _operands(r)
        return a[0] == w[0] == e and set(a[1:] + w[1:]) <= {slots, d, f}
    port = sum(r.flops * r.count for r in records if expert(r))
    assert port == 12 * _n_moe_layers(cfg) * 2 * e * slots * d * f, port
    want = _ref_dots(dots, lambda *dims: all(
        len(t) == 3 and t[0] == e for t in dims) and any(
            cap in t for t in dims))
    assert want == pytest.approx(2 * port, rel=1e-12), (want, port)
    return port, want


def _n_moe_layers(cfg):
    """The MoE layers of a cell's config: every layer, or in a hybrid's
    period its SSM layers' MoE FFNs and the attention layer's."""
    if not cfg.hybrid_period:
        return cfg.n_layers
    from repro_torch.models.lm import hybrid_ssm_split
    return (hybrid_ssm_split(cfg)[0] + 1) * (cfg.n_layers
                                             // cfg.hybrid_period)


def _together(*causes):
    """A cell's causes, each held to its formula: the sums of (the
    port's FLOPs, the reference's)."""
    def cause(records, dots, cfg, shape, modes=(), skipped=0.0):
        parts = [c(records, dots, cfg, shape, modes, skipped)
                 for c in causes]
        return sum(p for p, _ in parts), sum(w for _, w in parts)
    cause.__name__ = "+".join(c.__name__ for c in causes)
    return cause


def fsdp_cp_causes(arch, multi=False):
    """An ``fsdp_cp`` train cell's causes: the head's rows (its
    vocabulary whole on every rank; qwen2_vl's the reference splits over
    every rank, as the port counts it), the flash scans (every
    architecture with attention past ``auto``'s 2048-key threshold),
    the MoE's router, and on 2 x 16 x 16 the MoE's experts, repeated by
    each pod."""
    moe = get_config(arch).moe is not None
    return _together(*([_head_rows] if arch != "qwen2_vl_72b" else [])
                     + ([_cp_attention] if arch not in (
                         "mamba2_2_7b", "t5_large", "whisper_tiny") else [])
                     + ([_router_rows] if moe else [])
                     + ([_pod_experts] if moe and multi else []))

#: (arch, shape, modes) → the stated cause of work the reference does
#: and the port does not: a function (records, the reference's ``dots``,
#: cfg, shape, modes) → (the port's FLOPs of that kind, the
#: reference's), each held to its formula; the rest of each side is held
#: within 10 %
CAUSES = {**{(a, "train_4k", m): _head_rows
             for a in ("gpt2_345m", "bert_large", "bert_exlarge",
                       "mamba2_2_7b", "whisper_tiny")
             for m in ((), ("multi",))},
          **{("jamba_v0_1_52b", "prefill_32k", m): _whole_down
             for m in ((), ("multi",))},
          **{("jamba_v0_1_52b", s, ("baseline",)): _whole_ffn
             for s in ("train_4k", "prefill_32k")},
          ("jamba_v0_1_52b", "decode_32k", ("multi",)): _pod_ffn,
          **{(a, "train_4k", ("multi",) * multi + ("fsdp_cp",)):
             fsdp_cp_causes(a, multi) for a in list_archs()
             for multi in (False, True)}}

#: cells whose collective bytes are held to the reference's with every
#: operand of its combined collectives counted
#: (``test_torch_dryrun_ref.every_operand_total``): XLA merges a layer's
#: all-reduces into tuple-shaped ones, of which ``hlo_stats`` counts the
#: first operand only (``src/repro/core/roofline.py`` ``_INSTR_RE``)
COMBINED = {("t5_large", "train_4k", ("baseline",)),
            ("whisper_tiny", "prefill_32k", ("baseline",))}


#: the port's trace of each cell, by its config (names aside) and shape:
#: bert_large and bert_exlarge are one cell at one layer
_TRACES = {}


class _NoMemTracker:
    """Stands in for ``MemTracker`` in the held traces, which read no
    memory: tracking it costs about a fifth of a trace."""

    def track_external(self, *tensors):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get_tracker_snapshot(self, kind):
        return {}


def _trace(arch, shape, layers, monkeypatch, modes=()):
    """(flops as run, skipped pairs' flops, collective bytes, records)
    of the port's cell in ``modes``, traced once, its memory
    untracked."""
    cfg = D.cell_config(arch, layers=layers)
    key = (repr(dataclasses.replace(cfg, name="", source="")), shape,
           tuple(modes))
    if key not in _TRACES:
        skipped = dr._skipped_pairs_flops(monkeypatch)
        traced = {}
        trace_step = D.trace_step

        def keep(*args, **kwargs):
            out = trace_step(*args, **kwargs)
            traced["records"] = out[1].records
            return out

        monkeypatch.setattr(D, "trace_step", keep)
        from torch.distributed._tools import mem_tracker
        monkeypatch.setattr(mem_tracker, "MemTracker", _NoMemTracker)
        rep, _ = D.lower_cell(arch, shape, "multi" in modes,
                              "baseline" in modes,
                              "fsdp_cp" if "fsdp_cp" in modes else "tp_sp",
                              device="cpu", layers=layers)
        _TRACES[key] = (rep.hlo_flops, sum(skipped), rep.coll_bytes,
                        traced["records"])
    return _TRACES[key]


def check_cell(reference, arch, shape, layers, monkeypatch, modes=()):
    """Trace the port's cell once and hold it to the reference's."""
    flops, skipped, coll, records = _trace(arch, shape, layers, monkeypatch,
                                           modes)
    want = reference[ref.cell_key(arch, shape, layers, *modes)]
    every, total = residual(want, flops, skipped, records, arch, shape,
                            layers, modes)
    assert abs(every - total) <= CLOSE * total, (every, total)
    assert 0 < coll <= (1 + CLOSE) * coll_bar(want, arch, shape, modes), (
        coll, want["total"], want["every_operand"])


def coll_bar(want, arch, shape, modes=()):
    """The reference's collective bytes a cell is held to: its count, or
    for a cell of :data:`COMBINED` its count with every operand of its
    combined collectives, which must then exceed its count."""
    if (arch, shape, tuple(modes)) not in COMBINED:
        return want["total"]
    assert want["every_operand"] > want["total"]
    return want["every_operand"]


def residual(want, flops, skipped, records, arch, shape, layers,
             modes=()):
    """(the port's no-skip FLOPs — ``flops`` as traced plus the
    ``skipped`` pairs' —, the reference's) less, for a cell of
    :data:`CAUSES`, each side's products of the stated cause, held to
    their formulas first; the reference's dots by shape must sum to its
    count."""
    assert sum(want["dots"].values()) == pytest.approx(want["flops"],
                                                       rel=1e-12)
    every, total = flops + skipped, want["flops"]
    cause = CAUSES.get((arch, shape, tuple(modes)))
    if cause is not None:
        port, ref_part = cause(records, want["dots"],
                               D.cell_config(arch, layers=layers), shape,
                               modes, skipped)
        every, total = every - port, total - ref_part
    return every, total


def table(kinds, modes=()):
    """Print one markdown row per cell of ``kinds`` in ``modes``: the
    port's no-skip FLOPs over the reference's (and, for a cell of
    :data:`CAUSES`, the rest of each side's over each other, the
    products of the cause held to their formulas and taken out) and its
    collective bytes over the reference's. A cell that does not lower
    says so."""
    import tempfile
    all_cells = [c for k in kinds for c in cells(k, *modes)]
    with tempfile.TemporaryDirectory() as tmp:
        want = _lower_reference(all_cells, pathlib.Path(tmp) / "ref.json")
    mesh = "2×16×16" if "multi" in modes else "16×16"
    print(f"| cell ({', '.join([mesh, *[m for m in modes if m != 'multi']])})"
          " | FLOPs port / ref | held to its cause | coll. bytes port / ref |")
    print("|---|---|---|---|")
    for arch, shape, layers, *_ in all_cells:
        w = want[ref.cell_key(arch, shape, layers, *modes)]
        try:
            with pytest.MonkeyPatch.context() as mp:
                flops, skipped, coll, records = _trace(arch, shape, layers,
                                                       mp, modes)
        except Exception as e:             # noqa: BLE001 - a table row
            print(f"| {arch} {shape} ({layers}) | does not lower: "
                  f"{type(e).__name__} | | |", flush=True)
            continue
        try:
            every, total = residual(w, flops, skipped, records, arch,
                                    shape, layers, modes)
            held = "" if (arch, shape, tuple(modes)) not in CAUSES else \
                f"{every / total:.3f}"
        except AssertionError:             # a table row: the cause unmet
            held = "cause not met"
        combined = "" if (arch, shape, tuple(modes)) not in COMBINED else \
            f" ({coll / coll_bar(w, arch, shape, modes):.2f} of every operand)"
        print(f"| {arch} {shape} ({layers}) | "
              f"{(flops + skipped) / w['flops']:.3f} | {held} | "
              f"{coll / w['total']:.2f}{combined} |", flush=True)


if __name__ == "__main__":
    # python tests/test_torch_dryrun_held.py [--baseline] [--multi]
    #     [--fsdp_cp] [train] [prefill] [decode]
    args = sys.argv[1:]
    chosen = tuple(m for m in ref.MODES if f"--{m}" in args)
    table([a for a in args if not a.startswith("--")]
          or ["train", "prefill", "decode"], chosen)
