"""The reference's side of ``tests/test_torch_dryrun.py``: one child
python on 4 forced CPU devices lowers each smoke cell of its family
(:func:`cells_of`) on the ``(data, model)`` mesh :data:`MESH` with the
reference's own
``model_options``, ``param_specs``, ``zero1_specs``, ``batch_specs`` and
step factories, as its dry run does, and saves ``hlo_stats`` of each
compiled module. No tests of its own.

The mesh's axes are ``Auto``, as jax made them when the reference was
written (jax 0.9 defaults to ``Explicit``, under which the reference's
sharding constraints fail as asserts).

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
devices when imported: the child makes jax start its 4 devices first,
so the flag it sets then changes nothing, and the test process never
imports it.

    python tests/test_torch_dryrun_ref.py <out.json>
    python tests/test_torch_dryrun_ref.py --production <out.json> \
        <arch>:<shape>:<layers>[:baseline][:multi][:fsdp_cp] ...

The second form lowers full-width cells on the production mesh at a
depth cut (:func:`production_cells`), for
``tests/test_torch_dryrun_held_*.py``,
``tests/test_torch_dryrun_baseline_*.py`` and ``chip_smoke.py``'s
``DRYRUN_REFERENCE_FLOPS`` / ``DRYRUN_REFERENCE_COLL``: on 16 x 16 with
the default mapping, or in the cell's named mode — ``baseline``, the
reference's ``lower_cell(..., baseline=True)`` (the paper-faithful
mapping), ``multi``, the 2 x 16 x 16 mesh with axes ``("pod",
"data", "model")``, and ``fsdp_cp``, ``--mapping fsdp_cp`` (no tensor
parallelism, the sequence over ``model``, ZeRO-3). A cell's name is ``arch/shape/layers`` followed by
its modes (:func:`cell_key`).
"""
import json
import sys

#: one smoke config per model family, each a train and a prefill cell
FAMILIES = {"dense": "qwen2_1_5b", "moe": "qwen3_moe_30b_a3b",
            "ssm": "mamba2_2_7b", "hybrid": "jamba_v0_1_52b",
            "vlm": "qwen2_vl_72b", "audio": "whisper_tiny"}
#: (kind, seq, global batch) of the cells; seq 1024 keeps ``auto`` on
#: the naive attention (no block skipping), 4096 takes the flash path
CELLS = [(kind, seq, 8) for kind in ("train", "prefill")
         for seq in (1024, 4096)]
#: decode cells (``make_serve_step`` over a cache of seq slots, placed
#: by ``cache_specs(seq_axis="data")``) of the families whose decode
#: differs most from the others: the MoE's, whose FFN takes
#: ``moe_impl="gather"`` in decode, and the enc-dec's cross-attention
DECODE_CELLS = {"moe": [("decode", 1024, 8)],
                "audio": [("decode", 1024, 8)]}
#: the ``(data, model)`` mesh of every cell: the model split over two
#: ranks (the SSM block by heads, as XLA splits it)
MESH = (2, 2)


def cells_of(family):
    """(kind, seq, global batch) of a family's cells."""
    return CELLS + DECODE_CELLS.get(family, [])


def cell_name(arch, kind, seq):
    return f"{arch}/{kind}_{seq}"


def reference_cells(out_json):
    import warnings
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    assert len(jax.devices()) == 4, jax.devices()
    from repro.launch import dryrun as RD                # noqa: E402
    from repro.configs.base import ShapeConfig, get_config, smoke_config
    from repro.core.roofline import hlo_stats
    from repro.launch.mesh import batch_axes
    from repro.models.api import build_model, input_specs
    from repro.parallel import sharding
    from repro.train import optimizer as optlib
    from repro.train.step import (TrainConfig, make_prefill_step,
                                  make_serve_step, make_train_step)

    # Auto axes: the reference's meshes were Auto when it was written;
    # jax 0.9 makes Explicit ones by default, under which its sharding
    # constraints act as asserts
    out = {}
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    bax = batch_axes(mesh)
    for family, arch in FAMILIES.items():
        cfg = smoke_config(get_config(arch))
        for kind, seq, gb in cells_of(family):
            shape = ShapeConfig(f"{kind}_{seq}", seq, gb, kind)
            opts = RD.model_options(cfg, shape, mesh)
            pshapes = jax.eval_shape(lambda: build_model(cfg, opts).init(
                jax.random.PRNGKey(0)))
            fsdp = "data" if kind == "train" else None
            pspecs = sharding.param_specs(pshapes, mesh, fsdp_axes=fsdp)
            batch = input_specs(cfg, shape, opts)
            bspecs = sharding.batch_specs(batch, mesh, bax)
            with jax.set_mesh(mesh):
                if kind == "train":
                    step = make_train_step(cfg, opts, TrainConfig(),
                                           grad_specs=pspecs)
                    ostate = jax.eval_shape(optlib.init, pshapes)
                    ospecs = sharding.zero1_specs(
                        ostate, optlib.state_specs(pspecs), mesh)
                    lowered = jax.jit(
                        step, in_shardings=(pspecs, ospecs, bspecs),
                        out_shardings=(pspecs, ospecs, None),
                        donate_argnums=(0, 1)).lower(pshapes, ostate, batch)
                elif kind == "prefill":
                    lowered = jax.jit(
                        make_prefill_step(cfg, opts),
                        in_shardings=(pspecs, bspecs)).lower(pshapes, batch)
                else:
                    cache, batch = batch["cache"], batch["batch"]
                    cspecs = sharding.cache_specs(cache, mesh, bax,
                                                  seq_axis="data")
                    lowered = jax.jit(
                        make_serve_step(cfg, opts),
                        in_shardings=(pspecs, cspecs, sharding.batch_specs(
                            batch, mesh, bax)),
                        out_shardings=(None, cspecs),
                        donate_argnums=(1,)).lower(pshapes, cache, batch)
            out[cell_name(arch, kind, seq)] = hlo_stats(
                lowered.compile().as_text())
    with open(out_json, "w") as f:
        json.dump(out, f)


def dot_flops(hlo_text):
    """The dot FLOPs of ``hlo_stats(hlo_text)["flops"]`` by the dot's
    shapes: ``{"res|lhs|rhs": flops}`` (each a comma-joined dims string),
    each dot's FLOPs times the trip counts of the loops around it, read
    with the same rules as ``repro.core.roofline.hlo_stats`` (the loop
    bodies times their trip counts, fused and called computations once,
    collectives' reducers never)."""
    from repro.core import roofline as RR
    comps, entry = RR._split_computations(hlo_text)
    dims = {}
    for lines in comps.values():
        for line in lines:
            m = RR._RESULT_RE.match(line)
            if m:
                dims[m.group(1)] = m.group(3)
    out = {}

    def trip_count(cond):
        consts = [int(c) for line in comps.get(cond, ())
                  for c in RR._CONST_RE.findall(line)]
        return max(consts) if consts else 1

    def walk(name, mult, stack=()):
        if name in stack or name not in comps:
            return
        for line in comps[name]:
            if RR._line_traffic(line):
                continue
            rm = RR._RESULT_RE.match(line)
            om = RR._OPCODE_RE.search(line)
            opcode = om.group(1) if om else ""
            if opcode == "dot" and rm and rm.group(2) in RR._DTYPE_BYTES:
                ops = RR._OPERAND_RE.findall(
                    line[line.find("dot(") + 4:].split(")")[0])
                res = [int(d) for d in rm.group(3).split(",") if d]
                k = 1
                cd = RR._LHS_CDIM_RE.search(line)
                lhs = [int(d) for d in dims.get(ops[0], "").split(",") if d]
                if cd and lhs:
                    for di in cd.group(1).split(","):
                        if di:
                            k *= lhs[int(di)]
                key = "|".join([rm.group(3)] + [dims.get(o, "?")
                                                for o in ops[:2]])
                n = 1
                for d in res:
                    n *= d
                out[key] = out.get(key, 0.0) + mult * 2.0 * n * k
            wm = RR._WHILE_RE.search(line)
            if wm:
                cond = wm.group(1) or wm.group(4)
                walk(wm.group(2) or wm.group(3),
                     mult * (trip_count(cond) if cond else 1),
                     stack + (name,))
            elif opcode in ("fusion", "call", "custom-call", "conditional"):
                for callee in RR._CALL_RE.findall(line):
                    walk(callee, mult, stack + (name,))
    if entry:
        walk(entry, 1)
    return out


def every_operand_total(hlo_text):
    """``hlo_stats(hlo_text)["total"]`` with every operand of a combined
    (tuple-shaped) collective counted: XLA's combiner merges several
    all-reduces into one instruction whose result is a tuple, and
    ``hlo_stats`` reads a collective's first shape only
    (``repro.core.roofline._INSTR_RE``), so it counts one operand of
    each. Each such instruction is split into one line an operand (its
    groups, reducer and operand kept), and ``hlo_stats`` counts them by
    its own rules."""
    import re
    from repro.core import roofline as RR
    line_re = re.compile(
        r"^(\s*(?:ROOT )?%)([\w.\-]+)( = )\((.*?)\) ("
        + "|".join(RR._COLL_OPS) + r")(-start)?\(([^)]*)\)(.*)$")
    shape_re = re.compile(r"\w+\[[0-9,]*\](?:\{[0-9,]*\})?")
    out = []
    for line in hlo_text.splitlines():
        m = line_re.match(line)
        shapes = shape_re.findall(m.group(4)) if m else []
        operands = re.findall(r"%[\w.\-]+", m.group(7)) if m else []
        if not m or len(shapes) < 2 or len(shapes) != len(operands):
            out.append(line)
            continue
        pre, name, eq, _, op, start, _, rest = m.groups()
        out += [f"{pre}{name}.operand{i}{eq}{sh} {op}{start or ''}({o}){rest}"
                for i, (sh, o) in enumerate(zip(shapes, operands))]
    return RR.hlo_stats("\n".join(out))["total"]


#: the modes a production cell may name, after its layers
MODES = ("baseline", "multi", "fsdp_cp")


def cell_key(arch, shape, layers, *modes):
    """The name of a production cell: ``arch/shape/layers``, then each
    of its modes (in :data:`MODES` order)."""
    return "/".join([arch, shape, str(layers)]
                    + [m for m in MODES if m in modes])


def parse_cell(text):
    """``arch:shape:layers[:baseline][:multi][:fsdp_cp]`` → (arch, shape,
    layers, baseline, multi, mapping)."""
    arch, shape, layers, *modes = text.split(":")
    unknown = set(modes) - set(MODES)
    if unknown:
        raise ValueError(f"unknown mode(s) {sorted(unknown)} in {text!r}")
    return (arch, shape, int(layers), "baseline" in modes, "multi" in modes,
            "fsdp_cp" if "fsdp_cp" in modes else "tp_sp")


def production_cells(out_json, cells):
    """``hlo_stats`` of each (arch, shape, layers, baseline, multi,
    mapping) of ``cells`` as the reference's own dry run lowers it on its
    production mesh — 16 x 16, or 2 x 16 x 16 with ``multi`` — in the
    paper-faithful mapping with ``baseline``, in ``mapping`` (``tp_sp``
    or ``fsdp_cp``), its config cut to ``layers`` (widths
    kept), by cell name (:func:`cell_key`), with its dot FLOPs by shape
    under ``dots`` (:func:`dot_flops`) and its collective bytes with
    every operand of a combined collective counted under
    ``every_operand`` (:func:`every_operand_total`). Its ``repro.launch.dryrun`` is
    imported first (it sets ``XLA_FLAGS`` to 512 devices); the mesh's
    axes are ``Auto``, as above."""
    import dataclasses
    import os
    import warnings
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.launch import dryrun as RD                # noqa: E402
    # less effort in the CPU backend's code generation: the HLO after
    # the SPMD partitioner, which hlo_stats reads, is the same (equal
    # counts on gpt2, h2o and jamba train_4k), in about 60 % of the time
    os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                                " --xla_llvm_disable_expensive_passes=true")
    import jax
    from repro.core import roofline as RR

    def production_mesh(multi_pod=False):
        shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                       else ((16, 16), ("data", "model")))
        return jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(axes))

    RD.make_production_mesh = production_mesh
    config_of = RD.get_config
    analyze = RR.analyze
    out, seen = {}, {}
    for arch, shape, layers, baseline, multi, mapping in cells:
        name = cell_key(arch, shape, layers,
                        *(["baseline"] if baseline else []),
                        *(["multi"] if multi else []),
                        *([mapping] if mapping != "tp_sp" else []))
        cfg = dataclasses.replace(config_of(arch), n_layers=layers)
        same = (repr(dataclasses.replace(cfg, name="", source="")), shape,
                baseline, multi, mapping)
        if same in seen:       # bert_large and bert_exlarge at one layer
            out[name] = out[seen[same]]
            continue
        seen[same] = name
        stats = {}

        def keep_stats(arch, shape, mesh_name, n_chips, cost, hlo, *a, **k):
            stats.update(RR.hlo_stats(hlo), dots=dot_flops(hlo),
                         every_operand=every_operand_total(hlo))
            return analyze(arch, shape, mesh_name, n_chips, cost, hlo, *a,
                           **k)
        RD.get_config = lambda a, _n=layers: dataclasses.replace(
            config_of(a), n_layers=_n)
        RD.roofline.analyze = keep_stats
        try:
            RD.lower_cell(arch, shape, multi, baseline, mapping)
        finally:
            RD.get_config, RD.roofline.analyze = config_of, analyze
        out[name] = stats
    with open(out_json, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "--production":
        production_cells(sys.argv[2], [parse_cell(c) for c in sys.argv[3:]])
    else:
        reference_cells(sys.argv[1])
