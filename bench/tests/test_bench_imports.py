"""No module of the benchmark imports the JAX stack or the JAX package
(``repro``); the reference imports nothing of the program either. Names
are compared whole at the top level: ``repro_torch`` is not ``repro``."""
import ast
import sys

import pytest

from bench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "math", "typing", "torch"}


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"repro", "jaxlib"} <= set(harness.loaded_forbidden())


def test_the_harness_with_the_program_loads_no_jax():
    import subprocess
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "from bench import harness, run, control, faults, tracing;"
            "from bench.kinds import train, prefill;"
            "import repro_torch.train.step, repro_torch.kernels.ops;"
            "print(harness.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
