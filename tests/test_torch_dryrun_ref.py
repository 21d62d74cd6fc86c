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
        <arch>:<shape>:<layers> ...

The second form lowers full-width cells on the 16 x 16 production mesh
at a depth cut (:func:`production_cells`), for
``tests/test_torch_dryrun_sweep.py``.
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


def production_cells(out_json, cells):
    """``hlo_stats`` of each (arch, shape, layers) of ``cells`` as the
    reference's own dry run lowers it on the 16 x 16 production mesh, its
    config cut to ``layers`` (widths kept), by cell name
    ``arch/shape/layers``. Its ``repro.launch.dryrun`` is imported first
    (it sets ``XLA_FLAGS`` to 512 devices); the mesh's axes are ``Auto``,
    as above."""
    import dataclasses
    import warnings
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.launch import dryrun as RD                # noqa: E402
    import jax
    from repro.core import roofline as RR

    RD.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (16, 16), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    config_of = RD.get_config
    analyze = RR.analyze
    out = {}
    for arch, shape, layers in cells:
        stats = {}

        def keep_stats(arch, shape, mesh_name, n_chips, cost, hlo, *a, **k):
            stats.update(RR.hlo_stats(hlo))
            return analyze(arch, shape, mesh_name, n_chips, cost, hlo, *a,
                           **k)
        RD.get_config = lambda a, _n=layers: dataclasses.replace(
            config_of(a), n_layers=_n)
        RD.roofline.analyze = keep_stats
        try:
            RD.lower_cell(arch, shape, False)
        finally:
            RD.get_config, RD.roofline.analyze = config_of, analyze
        out[f"{arch}/{shape}/{layers}"] = stats
    with open(out_json, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "--production":
        production_cells(sys.argv[2], [
            (a, s, int(n)) for a, s, n in
            (c.split(":") for c in sys.argv[3:])])
    else:
        reference_cells(sys.argv[1])
