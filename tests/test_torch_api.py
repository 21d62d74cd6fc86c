"""The port's shape functions against the reference's, at full width:
``repro_torch.models.lm.param_shapes`` against ``repro.models.lm.
param_shapes`` (``jax.eval_shape`` of the reference's init) and
``repro_torch.models.api.scenario_input_specs`` against ``repro.models.
api.scenario_input_specs``, for every config and every ``Scenario``
kind: the same leaves, each of the same shape and dtype. Neither
allocates: the port builds its trees on the ``meta`` device, so even the
123 B-parameter configs take no memory.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.base import get_config as ref_get_config
from repro.core import scenario as ref_scenario
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core import scenario
from repro_torch.models import api, lm

ARCHS = list(list_archs())
#: one of each Scenario kind, by the name of its class
SCENARIOS = {"TrainStep": {}, "Prefill": {},
             "Decode": dict(steps=16, context=3000)}
BATCH, SEQ = 8, 4096


def configs(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


def reference_leaves(tree):
    """{path: (shape, dtype name)} of a tree of ShapeDtypeStructs."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def port_leaves(tree, prefix=()):
    """{path: (shape, dtype name)} of a tree of TensorSpecs (dicts and
    SSMCaches, named as jax names their keys and fields)."""
    if isinstance(tree, api.TensorSpec):
        return {"/".join(prefix): (tuple(tree.shape),
                                   str(tree.dtype).split(".")[-1])}
    items = tree.items() if isinstance(tree, dict) \
        else zip(tree._fields, tree)
    out = {}
    for k, v in items:
        out.update(port_leaves(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_the_reference(arch):
    ref_cfg, cfg = configs(arch)
    got = lm.param_shapes(cfg)
    want = ref_lm.param_shapes(ref_cfg)
    assert port_leaves(got) == reference_leaves(want)


@pytest.mark.parametrize("kind", sorted(SCENARIOS))
@pytest.mark.parametrize("arch", ARCHS)
def test_scenario_input_specs_match_the_reference(arch, kind):
    ref_cfg, cfg = configs(arch)
    got = api.scenario_input_specs(
        cfg, getattr(scenario, kind)(**SCENARIOS[kind]), BATCH, SEQ)
    want = ref_api.scenario_input_specs(
        ref_cfg, getattr(ref_scenario, kind)(**SCENARIOS[kind]), BATCH, SEQ)
    assert port_leaves(got) == reference_leaves(want)


def test_param_shapes_allocate_nothing(monkeypatch):
    """The tree of the largest config is built on the ``meta`` device:
    every tensor ``init_params`` makes there lives on it."""
    made = []
    init = lm.init_params

    def spy(*args, **kwargs):
        params = init(*args, **kwargs)
        made.extend(t.device.type for t in jax.tree_util.tree_leaves(
            params))
        return params
    monkeypatch.setattr(lm, "init_params", spy)
    shapes = lm.param_shapes(get_config("mistral_large_123b"))
    assert made and set(made) == {"meta"}
    assert all(isinstance(v, api.TensorSpec)
               for v in jax.tree_util.tree_leaves(
                   shapes, is_leaf=lambda x: isinstance(x, api.TensorSpec)))
