"""The reference's side of ``tests/test_torch_dryrun.py``: one child
python on 4 forced CPU devices lowers each smoke cell of :data:`CELLS`
on its family's ``(data, model)`` mesh (:func:`mesh_of`) with the
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
#: the families whose SSM block the port does not split over ``model``
#: (each rank runs it whole on its batch shard, where XLA splits it):
#: their cells are held on a mesh with no ``model`` split
NO_MODEL_SPLIT = ("ssm", "hybrid")


def mesh_of(family):
    """The ``(data, model)`` mesh of a family's cells."""
    return (4, 1) if family in NO_MODEL_SPLIT else (2, 2)


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
                                  make_train_step)

    # Auto axes: the reference's meshes were Auto when it was written;
    # jax 0.9 makes Explicit ones by default, under which its sharding
    # constraints act as asserts
    out = {}
    for family, arch in FAMILIES.items():
        mesh = jax.make_mesh(mesh_of(family), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        bax = batch_axes(mesh)
        cfg = smoke_config(get_config(arch))
        for kind, seq, gb in CELLS:
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
                else:
                    lowered = jax.jit(
                        make_prefill_step(cfg, opts),
                        in_shardings=(pspecs, bspecs)).lower(pshapes, batch)
            out[cell_name(arch, kind, seq)] = hlo_stats(
                lowered.compile().as_text())
    with open(out_json, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    reference_cells(sys.argv[1])
