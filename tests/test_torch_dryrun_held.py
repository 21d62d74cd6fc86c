"""Shared by ``tests/test_torch_dryrun_held_{train,prefill,decode}.py``
(no tests of its own): every cell of the dry run's sweep — each
architecture of ``list_archs()`` at each of its shapes — traced on the
16 x 16 production mesh at full width and 1 layer (jamba one period of
8), held to the reference's own dry run of the same cell.

The reference's counts come from one child python per file,
``tests/test_torch_dryrun_ref.py --production <out.json>
<arch>:<shape>:<layers> ...``, run by a module-scoped fixture. The
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
* Collective bytes: at most 10 % over the reference's.
"""
import dataclasses
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
#: the production mesh's (data, model) sizes, and the reference's
#: cross-entropy chunk
DATA, MODEL, CE_CHUNK = 16, 16, 512


def layers_of(arch):
    """The depth of a held cell: one layer, the hybrid one period."""
    cfg = get_config(arch)
    return cfg.hybrid_period or 1


def cells(kind):
    """(arch, shape, layers) of every sweep cell whose shape is of
    ``kind`` (train, prefill, or decode: decode_32k and long_500k)."""
    return [(a, s.name, layers_of(a)) for a in list_archs()
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


def params(cells_):
    return [pytest.param(*c, id="-".join(map(str, c))) for c in cells_]


def reference_fixture(name):
    """A module-scoped fixture: the reference's ``hlo_stats`` of
    ``file_cells(name)`` by ``arch/shape/layers``, from one child python
    (run before the port traces: on one core the two would only share
    it)."""
    @pytest.fixture(scope="module")
    def reference(tmp_path_factory):
        out = tmp_path_factory.mktemp(f"held_{name}") / "ref.json"
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(ref.__file__)), "--production",
             str(out)] + [":".join(map(str, c)) for c in file_cells(name)],
            capture_output=True, text=True, timeout=900,
            env=ranks.child_env(JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(out.read_text())
    return reference


def _product_flops(records, *mkn):
    """FLOPs of the traced ``aten.mm`` calls (m, k) x (k, n) at each of
    the (m, k, n) of ``mkn``."""
    def shape(r):
        a, b = (tuple(map(int, t.strip("()").split(", ")))
                for t in r.shapes.split("),("))
        return a[0], a[1], b[1]
    return sum(r.flops * r.count for r in records
               if r.op == "aten.mm.default" and shape(r) in mkn)


def _ref_dots(dots, keep):
    """The reference's dot FLOPs of the dots whose (result, lhs, rhs)
    dims tuples pass ``keep``."""
    return sum(f for key, f in dots.items()
               if keep(*(tuple(int(d) for d in part.split(",") if d)
                         for part in key.split("|"))))


def _head_rows(records, dots, cfg, shape):
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
    rows = SHAPES[shape].global_batch // DATA * (seq // MODEL)
    d, v = cfg.d_model, cfg.vocab
    # the forward, x's gradient, and the head's in either layout
    # (a tied head is the table's transpose)
    head = _product_flops(records, (rows, d, v), (rows, v, d), (d, rows, v),
                          (v, rows, d))
    assert head == 3 * 2 * rows * d * v, (head, rows)
    want = _ref_dots(dots, lambda *dims: any(v in t for t in dims))
    assert want == pytest.approx(seq // CE_CHUNK * head, rel=1e-12), (
        want, head)
    return head, want


def _whole_down(records, dots, cfg, shape):
    """The hybrid's prefill: the port splits the dense FFN over
    ``model`` (Megatron's column- and row-parallel products). The
    reference's XLA splits its up and gate products by rows and runs the
    down product whole on every rank: ``model`` times the port's. Holds
    the port's down products to their formula and the reference's, read
    from its HLO ((rows, d_ff) x (d_ff, d) at the whole d_ff), to
    ``model`` times the port's, both exactly; returns (the port's, the
    reference's)."""
    from repro_torch.models.lm import hybrid_ssm_split
    rows = SHAPES[shape].global_batch // DATA * SHAPES[shape].seq_len
    f, d = cfg.d_ff // MODEL, cfg.d_model
    n_dense = hybrid_ssm_split(cfg)[1] * (cfg.n_layers // cfg.hybrid_period)
    down = _product_flops(records, (rows, f, d))
    assert down == n_dense * 2 * rows * f * d, (down, n_dense)
    want = _ref_dots(dots, lambda res, lhs, rhs: (
        lhs == (rows, cfg.d_ff) and rhs == (cfg.d_ff, d)))
    assert want == pytest.approx(MODEL * down, rel=1e-12), (want, down)
    return down, want


#: (arch, shape) → the stated cause of work the reference does and the
#: port does not: a function (records, the reference's ``dots``, cfg,
#: shape) → (the port's FLOPs of that kind, the reference's), each held
#: to its formula; the rest of each side is held within 10 %
CAUSES = {**{(a, "train_4k"): _head_rows
             for a in ("gpt2_345m", "bert_large", "bert_exlarge",
                       "mamba2_2_7b", "whisper_tiny")},
          ("jamba_v0_1_52b", "prefill_32k"): _whole_down}


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


def _trace(arch, shape, layers, monkeypatch):
    """(flops as run, skipped pairs' flops, collective bytes, records)
    of the port's cell, traced once, its memory untracked."""
    cfg = D.cell_config(arch, layers=layers)
    key = (repr(dataclasses.replace(cfg, name="", source="")), shape)
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
        rep, _ = D.lower_cell(arch, shape, False, device="cpu",
                              layers=layers)
        _TRACES[key] = (rep.hlo_flops, sum(skipped), rep.coll_bytes,
                        traced["records"])
    return _TRACES[key]


def check_cell(reference, arch, shape, layers, monkeypatch):
    """Trace the port's cell once and hold it to the reference's."""
    flops, skipped, coll, records = _trace(arch, shape, layers, monkeypatch)
    want = reference[f"{arch}/{shape}/{layers}"]
    every, total = residual(want, flops + skipped, records, arch, shape,
                            layers)
    assert abs(every - total) <= CLOSE * total, (every, total)
    assert 0 < coll <= (1 + CLOSE) * want["total"], (coll, want["total"])


def residual(want, every, records, arch, shape, layers):
    """(the port's no-skip FLOPs ``every``, the reference's) less, for a
    cell of :data:`CAUSES`, each side's products of the stated cause,
    held to their formulas first; the reference's dots by shape must sum
    to its count."""
    assert sum(want["dots"].values()) == pytest.approx(want["flops"],
                                                       rel=1e-12)
    total = want["flops"]
    cause = CAUSES.get((arch, shape))
    if cause is not None:
        port, ref_part = cause(records, want["dots"],
                               D.cell_config(arch, layers=layers), shape)
        every, total = every - port, total - ref_part
    return every, total


def table(kinds):
    """Print one markdown row per cell of ``kinds``: the port's no-skip
    FLOPs over the reference's (and, for a cell of :data:`CAUSES`, the
    rest of each side's over each other, the products of the cause held
    to their formulas and taken out) and its collective bytes over the
    reference's."""
    import tempfile
    all_cells = [c for k in kinds for c in cells(k)]
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "ref.json"
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(ref.__file__)), "--production",
             str(out)] + [":".join(map(str, c)) for c in all_cells],
            capture_output=True, text=True,
            env=ranks.child_env(JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        want = json.loads(out.read_text())
    print("| cell (16×16) | FLOPs port / ref | held to its cause "
          "| coll. bytes port / ref |")
    print("|---|---|---|---|")
    for arch, shape, layers in all_cells:
        w = want[f"{arch}/{shape}/{layers}"]
        with pytest.MonkeyPatch.context() as mp:
            flops, skipped, coll, records = _trace(arch, shape, layers, mp)
        every, total = residual(w, flops + skipped, records, arch, shape,
                                layers)
        held = "" if (arch, shape) not in CAUSES else \
            f"{every / total:.3f}"
        print(f"| {arch} {shape} ({layers}) | "
              f"{(flops + skipped) / w['flops']:.3f} | {held} | "
              f"{coll / w['total']:.2f} |", flush=True)


if __name__ == "__main__":
    # python tests/test_torch_dryrun_held.py [train] [prefill] [decode]
    table(sys.argv[1:] or ["train", "prefill", "decode"])
