"""The port's checkpoint (``repro_torch.train.checkpoint``) against the
reference's ``repro.train.checkpoint``: the cases of
``tests/test_train_substrate.py`` over both packages, and checkpoints
that cross between them — same manifest, same leaf paths, same bytes,
bf16 included (numpy has no bf16: both write its raw 2-byte values under
the ``.npy`` descr ``<V2``).
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import layers as RL
from repro.models import lm as ref_lm
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch.models.convert import (optimizer_state_from_reference,
                                        params_from_reference)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import leaf_paths

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


class Ref:
    ckpt = ref_ckpt

    @staticmethod
    def tree(seed):
        key = jax.random.PRNGKey(seed)
        return {"a": jax.random.normal(key, (4, 8)),
                "nested": {"b": jnp.arange(6, dtype=jnp.int32)}}

    zeros = staticmethod(lambda shape, dtype="float32": jnp.zeros(
        shape, dtype=getattr(jnp, dtype)))
    leaves = staticmethod(lambda t: [np.asarray(x) for x in
                                     jax.tree.leaves(t)])


class Port:
    ckpt = ckpt

    @staticmethod
    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {"a": torch.randn((4, 8), generator=g),
                "nested": {"b": torch.arange(6, dtype=torch.int32)}}

    zeros = staticmethod(lambda shape, dtype="float32": torch.zeros(
        shape, dtype=getattr(torch, dtype)))
    leaves = staticmethod(lambda t: [x.numpy() for _, x in leaf_paths(t)])


BOTH = pytest.mark.parametrize("pkg", [Ref, Port], ids=["reference", "port"])


@BOTH
def test_checkpoint_roundtrip(pkg):
    tree = pkg.tree(0)
    with tempfile.TemporaryDirectory() as d:
        pkg.ckpt.save(d, 7, tree)
        restored, step = pkg.ckpt.restore(d, tree)
        assert step == 7
        for a, b in zip(pkg.leaves(tree), pkg.leaves(restored)):
            np.testing.assert_array_equal(a, b)


@BOTH
def test_checkpoint_retention_and_latest(pkg):
    tree = pkg.tree(1)
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            pkg.ckpt.save(d, s, tree, keep=2)
        assert pkg.ckpt.all_steps(d) == [4, 5]
        assert pkg.ckpt.latest_step(d) == 5


@BOTH
def test_checkpoint_keep_zero_retains_nothing(pkg):
    tree = pkg.tree(3)
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3):
            pkg.ckpt.save(d, s, tree, keep=0)
        assert pkg.ckpt.all_steps(d) == []
        with pytest.raises(ValueError):
            pkg.ckpt.save(d, 4, tree, keep=-1)


@BOTH
def test_checkpoint_shape_mismatch_fails_loudly(pkg):
    with tempfile.TemporaryDirectory() as d:
        pkg.ckpt.save(d, 1, {"a": pkg.zeros((2, 2))})
        with pytest.raises(ValueError, match="shape mismatch"):
            pkg.ckpt.restore(d, {"a": pkg.zeros((3, 3))})


@BOTH
def test_checkpoint_dtype_mismatch_fails_loudly(pkg):
    with tempfile.TemporaryDirectory() as d:
        pkg.ckpt.save(d, 1, {"a": pkg.zeros((2, 2))})
        with pytest.raises(ValueError, match="dtype mismatch"):
            pkg.ckpt.restore(d, {"a": pkg.zeros((2, 2), "int32")})


@BOTH
def test_checkpoint_missing_leaf_fails_loudly(pkg):
    with tempfile.TemporaryDirectory() as d:
        pkg.ckpt.save(d, 1, {"a": pkg.zeros((2, 2))})
        with pytest.raises(KeyError, match="missing leaf"):
            pkg.ckpt.restore(d, {"b": pkg.zeros((2, 2))})
        with pytest.raises(FileNotFoundError):
            pkg.ckpt.restore(os.path.join(d, "empty"), {"a": pkg.zeros(2)})


@BOTH
def test_checkpoint_atomicity_tmp_never_latest(pkg):
    tree = pkg.tree(2)
    with tempfile.TemporaryDirectory() as d:
        pkg.ckpt.save(d, 1, tree)
        os.makedirs(os.path.join(d, "step_00000002.tmp"))
        assert pkg.ckpt.latest_step(d) == 1


@pytest.mark.parametrize("module,forbidden", [
    ("repro.train.checkpoint", ("jax",)),
    ("repro_torch.train.checkpoint", ("jax", "repro"))])
def test_checkpoint_manifest_helpers_are_numpy_only(module, forbidden):
    """The manifest helpers feed engine-side restore sizing: importing
    the module drags in no jax (nor, for the port, the reference) —
    checked in a fresh interpreter."""
    code = (f"import sys\nimport {module} as c\n"
            "m = c.synthetic_manifest(4, {'pos0/params': 1000.0, "
            "'pos1/params': 24.0})\n"
            "assert m['step'] == 4\n"
            "assert [e['shape'] for e in m['leaves']] == [[250], [6]]\n"
            "assert c.manifest_nbytes(m) == 250 * 4 + 6 * 4\n"
            f"bad = [n for n in sys.modules if n.split('.')[0] in "
            f"{forbidden!r}]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], text=True,
                         capture_output=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_manifest_helpers_agree_with_the_reference():
    named = {"pos0/params": 1000.0, "pos1/opt": 24.0, "x": 3.0}
    for dtype in ("float32", "int8", "float16"):
        want = ref_ckpt.synthetic_manifest(3, named, dtype)
        assert ckpt.synthetic_manifest(3, named, dtype) == want
        assert ckpt.manifest_nbytes(want) == ref_ckpt.manifest_nbytes(want)
    bf16 = ckpt.synthetic_manifest(1, {"w": 10.0}, "bfloat16")
    assert bf16["leaves"][0]["shape"] == [5]
    assert ckpt.manifest_nbytes(bf16) == 10.0


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------

def bf16_trees(seed=5):
    """h2o_danube smoke parameters in bf16, as the reference's arrays and
    converted to the port."""
    cfg = ref_smoke_config(ref_get_config("h2o_danube_1_8b"))
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(seed),
                                RL.ModelOptions(dtype=jnp.bfloat16))
    host = jax.tree.map(np.asarray, params)
    return params, params_from_reference(host, device="cpu")


def dir_bytes(d):
    return {name: pathlib.Path(d, name).read_bytes()
            for name in sorted(os.listdir(d))}


def test_bf16_checkpoint_files_are_the_references_bytes():
    jparams, tparams = bf16_trees()
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        ref_ckpt.save(a, 3, jparams)
        ckpt.save(b, 3, tparams)
        want = dir_bytes(os.path.join(a, "step_00000003"))
        got = dir_bytes(os.path.join(b, "step_00000003"))
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(want["manifest.json"])
    assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16"}


def test_reference_bf16_checkpoint_restores_in_the_port_bit_exact():
    jparams, tparams = bf16_trees()
    template = jax.tree.map(torch.zeros_like, tparams)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(d, 9, jparams)
        restored, step = ckpt.restore(d, template)
    assert step == 9
    got, want = dict(leaf_paths(restored)), dict(leaf_paths(tparams))
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == torch.bfloat16
        assert torch.equal(got[name].view(torch.int16), t.view(torch.int16))


def test_port_bf16_checkpoint_reads_in_the_reference_as_its_own():
    """The reference reads the port's bf16 files exactly as it reads its
    own: the same raw values under ``np.load``, and the same outcome of
    its ``restore`` — which refuses its own bf16 leaves (it compares the
    loaded ``|V2`` with ``bfloat16``; ROADMAP.md, Queue 3)."""
    jparams, tparams = bf16_trees()
    outcomes = []
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        ref_ckpt.save(a, 1, jparams)
        ckpt.save(b, 1, tparams)
        for d in (a, b):
            leaf0 = np.load(os.path.join(d, "step_00000001", "arr_0.npy"))
            try:
                ref_ckpt.restore(d, jparams)
                outcomes.append(("restored", leaf0.tobytes()))
            except ValueError as e:
                outcomes.append((str(e), leaf0.tobytes()))
    assert outcomes[0] == outcomes[1]
    first = jax.tree.leaves(jparams)[0]
    assert outcomes[1][1] == np.asarray(first).tobytes()


def test_port_checkpoint_of_params_and_state_restores_in_the_reference():
    """fp32 parameters and an AdamW state after one reference update:
    the port's ``(params, state)`` checkpoint restores in the reference
    bit-exact, the step and tuple/NamedTuple paths included, and the
    reference's in the port."""
    cfg = ref_smoke_config(ref_get_config("qwen2_1_5b"))
    jp = ref_lm.init_params(cfg, jax.random.PRNGKey(1),
                            RL.ModelOptions(dtype=jnp.float32))
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, a.dtype), jp)
    jp, jstate, _ = ref_opt.update(ref_opt.AdamWConfig(), jp, grads,
                                   ref_opt.init(jp))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    tstate = optimizer_state_from_reference(
        jax.tree.map(np.asarray, jstate), device="cpu")
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        ckpt.save(a, 4, (tp, tstate))
        ref_ckpt.save(b, 4, (jp, jstate))
        assert json.loads(pathlib.Path(a, "step_00000004",
                                       "manifest.json").read_text()) \
            == json.loads(pathlib.Path(b, "step_00000004",
                                       "manifest.json").read_text())
        back, step = ref_ckpt.restore(a, (jp, jstate))
        tmpl = (jax.tree.map(torch.zeros_like, tp), opt.init(tp))
        there, step2 = ckpt.restore(b, tmpl)
    assert step == step2 == 4
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves((jp, jstate))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert isinstance(there[1], opt.AdamWState) and int(there[1].step) == 1
    for (p, x), (_, y) in zip(leaf_paths(there), leaf_paths((tp, tstate))):
        assert torch.equal(x, y), p
