"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's ``repro.parallel.sharding``: every leaf's spec of the
full-width placement tables of every config, on mesh-like stand-ins of
the reference's (1, 1), production (16, 16) and multi-pod (2, 16, 16)
meshes; the cases of ``tests/test_sharding.py`` over both packages;
``to_placements`` on a 2 x 2 gloo mesh against the slices of JAX's
``NamedSharding`` on 4 forced CPU devices; and the mesh constructors.

Shapes only: the reference's trees come from ``jax.eval_shape``, the
port's from its own init and cache on the ``meta`` device.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as JP

import test_torch_ranks as ranks
from repro.configs.base import get_config as ref_config
from repro.models.api import build_model as ref_build
from repro.models.layers import ModelOptions as RefOptions
from repro.parallel import sharding as R
from repro.train import optimizer as ropt
from repro_torch.configs.base import get_config, list_archs
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.api import build_model
from repro_torch.models.layers import ModelOptions
from repro_torch.parallel import sharding as S
from repro_torch.train import optimizer as opt


class FakeMesh:
    """The reference tests' mesh-like stand-in: a ``.shape`` mapping and
    ``.axis_names``."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"1x1": FakeMesh(data=1, model=1),
          "16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16)}
FSDP = (None, "data", ("data", "model"))


def ref_params(arch):
    return jax.eval_shape(lambda: ref_build(
        ref_config(arch), RefOptions(dtype=jnp.bfloat16)).init(jax.random.PRNGKey(0)))


def port_params(arch):
    return build_model(get_config(arch), ModelOptions(dtype=torch.bfloat16)).init(
        None, "meta")


def ref_table(specs):
    """{path: spec tuple} of a reference spec tree, paths named as
    ``tree_map_with_path`` names them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def port_table(specs):
    out = {}
    S._map(lambda path, spec: out.__setitem__("/".join(path), spec), specs)
    assert all(isinstance(s, S.P) for s in out.values())
    return out


def assert_same(port_specs, ref_specs):
    got, want = port_table(port_specs), ref_table(ref_specs)
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


# --------------------------------------------------------------------------
# full-width placement tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_and_zero1_tables_equal_the_references(arch):
    rshapes, pshapes = ref_params(arch), port_params(arch)
    rstate = jax.eval_shape(ropt.init, rshapes)
    pstate = opt.init(pshapes)
    for mesh in MESHES.values():
        for model_axis in ("model", "__no_tp__"):
            for fsdp in FSDP:
                want = R.param_specs(rshapes, mesh, model_axis, fsdp)
                got = S.param_specs(pshapes, mesh, model_axis, fsdp)
                assert_same(got, want)
            if model_axis == "model":
                # ZeRO-1 over the state of the FSDP-over-data table
                want = R.zero1_specs(rstate, ropt.state_specs(
                    R.param_specs(rshapes, mesh, fsdp_axes="data")), mesh)
                got = S.zero1_specs(pstate, opt.state_specs(
                    S.param_specs(pshapes, mesh, fsdp_axes="data")), mesh)
                assert_same(got, want)


CACHE_SHAPES = ((32, 2048), (1, 8192))


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_tables_equal_the_references(arch):
    rcfg, pcfg = ref_config(arch), get_config(arch)
    rapi = ref_build(rcfg, RefOptions(dtype=jnp.bfloat16))
    papi = build_model(pcfg, ModelOptions(dtype=torch.bfloat16))
    for mesh in MESHES.values():
        axes = launch_mesh.batch_axes(mesh)
        assert axes == tuple(a for a in mesh.axis_names
                             if a in ("pod", "data"))
        for b, s in CACHE_SHAPES:
            rcache = jax.eval_shape(lambda b=b, s=s: rapi.init_cache(b, s))
            pcache = papi.init_cache(b, s, device="meta")
            for seq_axis in (None, "data"):
                assert_same(S.cache_specs(pcache, mesh, axes,
                                          seq_axis=seq_axis),
                            R.cache_specs(rcache, mesh, axes,
                                          seq_axis=seq_axis))
            batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
            pbatch = {k: torch.empty(v.shape, device="meta")
                      for k, v in batch.items()}
            assert_same(S.batch_specs(pbatch, mesh, axes),
                        R.batch_specs(batch, mesh, axes))


def test_ssm_cache_fields_are_named_as_the_reference_names_them():
    cache = build_model(get_config("mamba2_2_7b"),
                        ModelOptions()).init_cache(2, 64, device="meta")
    names = set(port_table(S.cache_specs(cache, MESHES["16x16"],
                                         ("data",))))
    assert {"ssm/conv", "ssm/state"} <= names, names


def test_spec_equals_the_partition_spec_tuple():
    assert S.P(("data",), None) == tuple(JP(("data",), None))
    assert S.P(("data", "model"), []) == tuple(JP(("data", "model"), ()))
    assert S.P() == tuple(JP())
    assert repr(S.P("data", None)) == "P('data', None)"


# --------------------------------------------------------------------------
# the cases of tests/test_sharding.py over both packages
# --------------------------------------------------------------------------

def _axis_names(spec):
    for s in spec:
        if s is None:
            continue
        yield from (s if isinstance(s, tuple) else (s,))


def _both_specs(arch, fsdp=None, mesh=MESHES["1x1"]):
    """The reference's specs on its own (1, 1) mesh, and the port's on
    the stand-in."""
    rshapes = ref_params(arch)
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    return ({"repro": rshapes, "repro_torch": port_params(arch)},
            {"repro": R.param_specs(rshapes, rmesh, fsdp_axes=fsdp),
             "repro_torch": S.param_specs(port_params(arch), mesh,
                                          fsdp_axes=fsdp)})


def _leaves(pkg, specs):
    if pkg == "repro":
        return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    return S.spec_leaves(specs)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "mamba2_2_7b",
                                  "qwen3_moe_30b_a3b", "jamba_v0_1_52b",
                                  "whisper_tiny"])
def test_no_duplicate_axes_in_param_specs(arch):
    _, specs = _both_specs(arch, fsdp="data")
    for pkg, tree in specs.items():
        for spec in _leaves(pkg, tree):
            names = list(_axis_names(tuple(spec)))
            assert len(names) == len(set(names)), (pkg, spec)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "dbrx_132b"])
def test_zero1_never_duplicates_fsdp(arch):
    shapes, specs = _both_specs(arch, fsdp="data")
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {"repro": R.zero1_specs(jax.eval_shape(ropt.init, shapes["repro"]),
                                  ropt.state_specs(specs["repro"]), rmesh),
           "repro_torch": S.zero1_specs(opt.init(shapes["repro_torch"]),
                                        opt.state_specs(
                                            specs["repro_torch"]),
                                        MESHES["1x1"])}
    for pkg, tree in out.items():
        for spec in _leaves(pkg, tree):
            names = list(_axis_names(tuple(spec)))
            assert len(names) == len(set(names)), (pkg, spec)


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_spec_dims_divide_mesh(pkg):
    """On the production mesh sizes (16, 16), every sharded dim divides."""
    fm = MESHES["16x16"]
    shapes = ref_params("mistral_large_123b") if pkg == "repro" \
        else port_params("mistral_large_123b")
    rules = R if pkg == "repro" else S
    specs = rules.param_specs(shapes, fm, fsdp_axes="data")
    table = ref_table(specs) if pkg == "repro" else port_table(specs)
    sizes = {}
    if pkg == "repro":
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            sizes["/".join(str(getattr(k, "key", k)) for k in path)] = \
                leaf.shape
    else:
        S._map(lambda path, leaf: sizes.__setitem__("/".join(path),
                                                    tuple(leaf.shape)),
               shapes)
    assert sizes.keys() == table.keys()
    for name, spec in table.items():
        for i, s in enumerate(spec):
            if s is None:
                continue
            size = 1
            for a in (s if isinstance(s, tuple) else (s,)):
                size *= fm.shape[a]
            assert sizes[name][i] % size == 0, (pkg, name, spec)


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_cache_specs_long_context_sequence_sharded(pkg):
    # synthetic KV leaf: (L, B=1, S, KH=8, hd) — batch unshardable,
    # kv-heads don't divide 16 ⇒ sequence must shard
    if pkg == "repro":
        leaf = jax.ShapeDtypeStruct((4, 1, 8192, 8, 64), jnp.bfloat16)
        spec = R.cache_specs({"k": leaf}, MESHES["16x16"], ("data",),
                             seq_axis="data")["k"]
    else:
        leaf = torch.empty((4, 1, 8192, 8, 64), device="meta")
        spec = S.cache_specs({"k": leaf}, MESHES["16x16"], ("data",),
                             seq_axis="data")["k"]
    assert spec[2] is not None          # sequence sharded
    assert spec[3] is None              # kv heads replicated


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_batch_specs_shard_dim0(pkg):
    if pkg == "repro":
        batch = {"tokens": jax.ShapeDtypeStruct((256, 128), jnp.int32),
                 "odd": jax.ShapeDtypeStruct((7, 128), jnp.int32)}
        specs = R.batch_specs(batch, MESHES["16x16"], ("data",))
    else:
        batch = {"tokens": torch.empty((256, 128), device="meta"),
                 "odd": torch.empty((7, 128), device="meta")}
        specs = S.batch_specs(batch, MESHES["16x16"], ("data",))
    assert specs["tokens"][0] == ("data",) or specs["tokens"][0] == "data"
    assert specs["odd"][0] is None      # 7 doesn't divide 16


# --------------------------------------------------------------------------
# to_placements on a real mesh, and the mesh constructors
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def placements_run(tmp_path_factory):
    return ranks.run(["placements"], 4, tmp_path_factory.mktemp("w4"))


@pytest.mark.parametrize("name", sorted(ranks.PLACEMENT_SPECS))
def test_each_ranks_shard_is_the_slice_jax_gives_its_device(placements_run,
                                                            name):
    """Rank r of the 2 x 2 gloo mesh (position (r // 2, r % 2)) holds
    exactly the slice ``NamedSharding(mesh, spec).devices_indices_map``
    gives the device at that position of a forced 4-device mesh (1-D,
    2-D and name-tuple specs, major to minor)."""
    ref, outs = placements_run
    want = ref[f"placements/{name}"]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"placements/{name}"], want[r])


def test_to_placements_refuses_what_dtensor_cannot_express():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")

    assert S.to_placements(S.P(None, ("data", "model")), Mesh()) == \
        (Shard(1), Shard(1))
    assert S.to_placements(S.P("model"), Mesh()) == (Replicate(), Shard(0))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        S.to_placements(S.P(("model", "data")), Mesh())
    with pytest.raises(ValueError, match="not axes of the mesh"):
        S.to_placements(S.P("pod"), Mesh())
    with pytest.raises(ValueError, match="twice"):
        S.to_placements(S.P("data", "data"), Mesh())


def test_meshes_need_a_process_group_of_their_size():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for make in (lambda: launch_mesh.make_production_mesh(),
                 lambda: launch_mesh.make_production_mesh(multi_pod=True),
                 lambda: launch_mesh.make_debug_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="none is initialised"):
            make()


def test_the_debug_mesh_defaults_to_the_card(tmp_path):
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError,
                           match="torch.cuda is not available"):
            launch_mesh.make_debug_mesh()
    finally:
        dist.destroy_process_group()


def test_the_debug_mesh_over_one_rank(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = launch_mesh.make_debug_mesh(1, 1, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert launch_mesh.batch_axes(mesh) == ("data",)
        assert S.mesh_shape(mesh) == {"data": 1, "model": 1}
        with pytest.raises(RuntimeError, match="it has 1"):
            launch_mesh.make_debug_mesh(2, 1, device="cpu")
        with S.use_mesh(mesh):
            assert S.current_mesh() is mesh
        with pytest.raises(RuntimeError, match="no mesh"):
            S.current_mesh()
    finally:
        dist.destroy_process_group()
