"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor the reference package ``repro`` — checked
statically over every source file and dynamically in a process that
imports every module of the port.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if f.exists()]


def forbidden_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                bad.append((node.lineno, name))
    return sorted(bad)


def test_there_is_something_to_check():
    names = {f.name for f in port_sources()}
    assert {"megabatch.py", "megabatch_scan.py", "serve.py",
            "flash_attention.py", "rmsnorm.py", "ops.py", "lm.py",
            "convert.py", "chip_smoke.py", "pipeline.py", "optimizer.py",
            "checkpoint.py", "fault_tolerance.py", "train_loop.py",
            "tree.py", "step.py", "perturb.py", "space.py", "cache.py",
            "engine.py", "report.py", "search.py", "metrics.py",
            "sweep.py", "executor.py", "degraded.py", "__main__.py",
            "_polling_reference.py", "findings.py", "graph.py", "lint.py",
            "moe.py", "ssm.py", "encdec.py", "sharding.py", "mesh.py",
            "train.py", "compression.py"} <= names
    for pkg in ("analyze", "models", "parallel", "launch"):
        assert (PORT / pkg / "__init__.py").exists(), pkg


@pytest.mark.parametrize(
    "path", port_sources(),
    ids=[str(f.relative_to(ROOT)) for f in port_sources()])
def test_no_jax_or_reference_import(path):
    assert forbidden_imports(path) == []


def test_the_walk_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from repro.core import x\n"
                 "import jax.numpy as jnp\nimport repro_torch\n")
    assert forbidden_imports(f) == [(2, "repro.core"), (3, "jax.numpy")]


def test_kernel_source_is_shipped_and_plain_c():
    csrc = PORT / "kernels" / "csrc"
    for name in ("megabatch_scan", "flash_attention", "flash_attention_tc",
                 "rmsnorm"):
        text = (csrc / f"{name}.cu").read_text()
        assert "__global__" in text and 'extern "C"' in text, name
        assert "torch/extension.h" not in text and "ATen" not in text, name
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper_ptx.cuh"]
    for header in headers:
        text = header.read_text()
        assert "torch/" not in text and "ATen" not in text, header.name


_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
from repro_torch.configs.base import list_archs
assert len(list_archs()) == 15
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "repro"))
assert not bad, bad
assert "triton" not in sys.modules
for name in ("repro_torch.analyze", "repro_torch.analyze.__main__",
             "repro_torch.analyze.graph", "repro_torch.analyze.lint",
             "repro_torch.models.moe", "repro_torch.models.ssm",
             "repro_torch.models.encdec", "repro_torch.parallel.sharding",
             "repro_torch.launch.mesh", "repro_torch.launch.train",
             "repro_torch.train.compression"):
    assert name in mods, name
assert "torch.distributed.tensor" not in sys.modules
print(len(mods))
"""


def test_importing_every_module_pulls_in_neither():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 89
