"""The port's static analysis (``repro_torch.analyze``) against the
reference's (``repro.analyze``): every seeded defect of
``tests/test_analyze.py`` is seeded the same way into each package's
engine or program, and both verifiers must give the same findings —
rule, message and where, in order — with the intended rule among them.
The clean runs (smoke, serving and degraded cells, the compiled
mega-batch, the source trees) give none in either package. The
``verify=`` hooks of the port's ``EventFlowEngine`` and ``MegaBatch``
raise at construction, and ``REPRO_VERIFY`` switches both packages the
same way. Pure numpy: nothing here needs a card (the port's programs
are compiled with ``device="cpu"``, which they never evaluate here).
"""
import dataclasses
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import repro.analyze as ref_analyze
import repro.analyze.findings as ref_findings
import repro.configs.base as ref_configs
import repro.core as ref_core
import repro.core.engine as ref_engine
import repro.validate as ref_validate
import repro_torch.analyze as port_analyze
import repro_torch.analyze.findings as port_findings
import repro_torch.configs.base as port_configs
import repro_torch.core as port_core
import repro_torch.core.engine as port_engine
import repro_torch.validate as port_validate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(analyze, findings, configs, core, engine, validate, mb_kwargs):
    provider = core.AnalyticalProvider(core.A40_CLUSTER)
    return types.SimpleNamespace(
        analyze=analyze, findings=findings, configs=configs, core=core,
        engine=engine, validate=validate, provider=provider,
        cache=validate.BuildCache(provider), mb_kwargs=mb_kwargs)


REF = _pkg(ref_analyze, ref_findings, ref_configs, ref_core, ref_engine,
           ref_validate, {})
PORT = _pkg(port_analyze, port_findings, port_configs, port_core,
            port_engine, port_validate, {"device": "cpu"})
PKGS = (REF, PORT)


def _engine(pkg, mp=1, pp=2, dp=1, m=4, schedule="1f1b"):
    """A small gpt2_345m engine built with verification OFF, to be
    mutated into a defect class."""
    cfg = pkg.configs.get_config("gpt2_345m")
    strat = pkg.core.Strategy(mp=mp, pp=pp, dp=dp, microbatches=m,
                              schedule=schedule)
    sim = pkg.core.DistSim(cfg, strat, dp * m, 128, pkg.provider)
    return pkg.engine.EventFlowEngine(sim.positions(), strat, pkg.provider,
                                      verify=False)


def _megabatch(pkg):
    engines = [pkg.cache.engine_for(c)
               for c in pkg.validate.smoke_matrix()[:3]]
    return pkg.core.MegaBatch(engines, verify=False, **pkg.mb_kwargs)


def _key(findings):
    return [(f.rule, f.message, f.where, f.severity) for f in findings]


# --------------------------------------------------------------------------
# seeded defects: the same mutation in each package, the same findings
# --------------------------------------------------------------------------

def _cycle(eng):
    for lst in (eng.task_isf, eng.task_pos, eng.task_micro,
                eng.task_name, eng.task_p2p_name):
        lst[1] = lst[1][::-1]
    eng._topo = None


def _dangling(eng):
    idx = next(i for i, isf in enumerate(eng.task_isf[1]) if isf)
    eng.task_micro[1] = list(eng.task_micro[1])
    eng.task_micro[1][idx] = eng.m + 5
    eng._topo = None


def _duplicate(eng):
    for name in ("task_isf", "task_pos", "task_micro", "task_name",
                 "task_p2p_name"):
        lst = getattr(eng, name)
        lst[0] = list(lst[0]) + [lst[1][0]]
    eng._topo = None


def _stale_topo(eng):
    eng._topo = list(reversed(eng.topo_order()))


def _misaligned(eng):
    eng.task_name[0] = list(eng.task_name[0])[:-1]


def _nan_mean(eng):
    eng.build.fwd_event_means[0] = [float("nan")] \
        + list(eng.build.fwd_event_means[0][1:])


ENGINE_DEFECTS = [
    ("clean", lambda eng: None, set(), True),
    ("G001-cycle", _cycle, {"G001"}, True),
    ("G002-dangling", _dangling, {"G002", "G003"}, False),
    ("G003-duplicate", _duplicate, {"G003"}, False),
    ("G004-stale-topo", _stale_topo, {"G004"}, False),
    ("G006-misaligned", _misaligned, {"G006"}, True),
    ("G009-nan-mean", _nan_mean, {"G009"}, False),
]


@pytest.mark.parametrize("mutate,rules,exact",
                         [d[1:] for d in ENGINE_DEFECTS],
                         ids=[d[0] for d in ENGINE_DEFECTS])
def test_engine_defects_give_the_references_findings(mutate, rules, exact):
    got = []
    for pkg in PKGS:
        eng = _engine(pkg)
        mutate(eng)
        got.append(pkg.analyze.verify_engine(eng))
    ref, port = got
    assert _key(port) == _key(ref)
    found = {f.rule for f in port}
    assert (found == rules) if exact else (rules <= found), found


def test_a_bare_build_gets_the_means_check():
    got = []
    for pkg in PKGS:
        eng = _engine(pkg)
        _nan_mean(eng)
        got.append(pkg.analyze.verify_build(eng.build))
    assert _key(got[1]) == _key(got[0])
    assert "G009" in {f.rule for f in got[1]}


def _forward_read(mb):
    n = mb.engines[1].total_tasks
    mb._dep1[0, 1] = mb._out[n - 1, 1]


def _foreign_read(mb):
    mb._dep2[0, 0] = mb._out[0, 1]


def _broken_chain(mb):
    mb._dep0[mb.engines[0].total_tasks // 2, 0] = 0


def _negative_duration(mb):
    mb._dur[0, 0] = -1.0


MEGABATCH_DEFECTS = [
    ("clean", lambda mb: None, set()),
    ("G005-write-before-read", _forward_read, {"G005"}),
    ("G005-foreign-candidate", _foreign_read, {"G005"}),
    ("G006-broken-chain", _broken_chain, {"G006"}),
    ("G005-negative-duration", _negative_duration, {"G005"}),
]


@pytest.mark.parametrize("mutate,rules", [d[1:] for d in MEGABATCH_DEFECTS],
                         ids=[d[0] for d in MEGABATCH_DEFECTS])
def test_megabatch_defects_give_the_references_findings(mutate, rules):
    got = []
    for pkg in PKGS:
        mb = _megabatch(pkg)
        mutate(mb)
        got.append(pkg.analyze.verify_megabatch(mb))
    assert _key(got[1]) == _key(got[0])
    assert rules <= {f.rule for f in got[1]}
    if not rules:
        assert got[1] == []


PERTURBATIONS = [
    ("G008-rank-outside", dict(mp=1, pp=2, dp=2), 99, 1, {"G008"}),
    ("G008-unrecoverable", dict(mp=2, pp=2, dp=1), 1, 1, {"G008"}),
    ("clean-survivable", dict(mp=1, pp=2, dp=2), 3, 2, set()),
]


@pytest.mark.parametrize("strat,rank,step,rules",
                         [d[1:] for d in PERTURBATIONS],
                         ids=[d[0] for d in PERTURBATIONS])
def test_perturbation_findings_are_the_references(strat, rank, step, rules):
    got = []
    for pkg in PKGS:
        s = pkg.core.Strategy(microbatches=4, **strat)
        p = pkg.core.Perturbation(
            faults=(pkg.core.Fault(rank=rank, at_step=step),), steps=8)
        got.append(pkg.analyze.verify_perturbation(p, s))
    assert _key(got[1]) == _key(got[0])
    assert {f.rule for f in got[1]} == rules


@pytest.mark.parametrize("arch,strat,micro,seq,rules", [
    ("gpt_145b", dict(mp=1, pp=1, dp=1, microbatches=1), 4, 2048,
     {"G010"}),
    ("gpt2_345m", dict(mp=2, pp=2, dp=1, microbatches=4), 1, 128, set()),
], ids=["G010-over-capacity", "clean-fits"])
def test_cell_memory_findings_are_the_references(arch, strat, micro, seq,
                                                 rules):
    got = []
    for pkg in PKGS:
        got.append(pkg.analyze.verify_cell_memory(
            pkg.configs.get_config(arch), pkg.core.Strategy(**strat), micro,
            seq, pkg.core.A40_CLUSTER.chip.hbm_bytes))
    assert _key(got[1]) == _key(got[0])
    assert {f.rule for f in got[1]} == rules


# --------------------------------------------------------------------------
# construction-time hooks and the environment switch
# --------------------------------------------------------------------------

def test_the_engine_hook_raises_at_construction(monkeypatch):
    eng = _engine(PORT)
    eng.build.p2p_base = float("inf")
    E = port_engine.EventFlowEngine
    with pytest.raises(port_analyze.GraphInvariantError, match="G009"):
        E(eng.stages, eng.strat, PORT.provider, build=eng.build,
          verify=True)
    monkeypatch.setenv("REPRO_VERIFY", "1")
    with pytest.raises(port_analyze.GraphInvariantError, match="G009"):
        E(eng.stages, eng.strat, PORT.provider, build=eng.build)
    E(eng.stages, eng.strat, PORT.provider, build=eng.build, verify=False)


def test_the_megabatch_hook_raises_at_construction(monkeypatch):
    """A stale topological order compiles into dependencies that read
    slots written at later steps: G005 at construction."""
    eng = _engine(PORT)
    _stale_topo(eng)
    with pytest.raises(port_analyze.GraphInvariantError, match="G005"):
        port_core.MegaBatch([eng], device="cpu", verify=True)
    monkeypatch.setenv("REPRO_VERIFY", "1")
    with pytest.raises(port_analyze.GraphInvariantError, match="G005"):
        port_core.MegaBatch([eng], device="cpu")
    port_core.MegaBatch([eng], device="cpu", verify=False)


@pytest.mark.parametrize("value,want", [(None, False), ("1", True),
                                        ("0", False), ("yes", True),
                                        ("", False), ("off", False)])
def test_default_verify_follows_the_environment_alike(monkeypatch, value,
                                                      want):
    assert port_findings.VERIFY_ENV == ref_findings.VERIFY_ENV \
        == "REPRO_VERIFY"
    if value is None:
        monkeypatch.delenv("REPRO_VERIFY", raising=False)
    else:
        monkeypatch.setenv("REPRO_VERIFY", value)
    for mod in (ref_findings, port_findings):
        assert mod.default_verify(None) is want
        assert mod.default_verify(True) is True
        assert mod.default_verify(False) is False


def test_raise_on_findings_severity():
    F = port_findings.Finding
    port_findings.raise_on_findings([])
    port_findings.raise_on_findings([F("GXXX", "note", severity="warning")])
    with pytest.raises(port_findings.GraphInvariantError, match="boom"):
        port_findings.raise_on_findings([F("GXXX", "boom")])
    assert str(F("G001", "m", "w")) == str(ref_findings.Finding("G001", "m",
                                                                "w"))


# --------------------------------------------------------------------------
# the linter: each fixture under the reference's and the port's paths
# --------------------------------------------------------------------------

L001 = "def f(e):\n    if e.name == 'fwd':\n        return 1\n"
L001B = "def f(ev):\n    return ev.name.startswith('p2p')\n"
L002 = ("import dataclasses\n"
        "@dataclasses.dataclass(frozen=True)\n"
        "class Spec:\n"
        "    mp: int = 1\n"
        "    pp: int = 1\n"
        "    zero1: bool = False\n"
        "    def to_dict(self):\n"
        "        return {'mp': self.mp, 'pp': self.pp}\n")
L002_FIXED = L002.replace("return {'mp': self.mp, 'pp': self.pp}",
                          "return dataclasses.asdict(self)")
L003 = ("def f(pu, au):\n"
        "    return {d: pu.get(d, 0.0) - au.get(d, 0.0)\n"
        "            for d in set(pu) | set(au)}\n")
L003_FIXED = L003.replace("set(pu) | set(au)}", "sorted(set(pu) | set(au))}")
TUPLE_OK = "def f(s):\n    return tuple(x for x in s)\n"
TUPLE_SET = "def f(s):\n    return tuple(x for x in set(s))\n"
WALLCLOCK = "import time\ndef f():\n    return time.time()\n"
UNSEEDED = "import numpy as np\ndef f():\n    return np.random.randn(3)\n"
SEEDED = ("import numpy as np\ndef f(seed):\n"
          "    return np.random.RandomState(seed).randn(3)\n")

LINT_CASES = [
    (L001, "src/{p}/x.py", {"L001"}),
    (L001B, "src/{p}/x.py", {"L001"}),
    (L002, "src/{p}/x.py", {"L002"}),
    (L002_FIXED, "src/{p}/x.py", set()),
    (L003, "src/{p}/core/fake.py", {"L003"}),
    (L003_FIXED, "src/{p}/core/fake.py", set()),
    (TUPLE_SET, "src/{p}/search/x.py", set()),
    (TUPLE_SET, "src/{p}/store/x.py", {"L003"}),
    (TUPLE_OK, "src/{p}/store/x.py", set()),
    (WALLCLOCK, "src/{p}/core/x.py", {"L004"}),
    (UNSEEDED, "src/{p}/store/x.py", {"L004"}),
    (WALLCLOCK, "src/{p}/core/profiler.py", set()),
    (SEEDED, "src/{p}/core/x.py", set()),
    ("def f(:\n", "x.py", {"L000"}),
]


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("src,path,rules", LINT_CASES,
                         ids=[f"{sorted(c[2]) or 'clean'}-{c[1]}-{i}"
                              for i, c in enumerate(LINT_CASES)])
def test_lint_fixtures_under_both_package_paths(package, src, path, rules):
    """Under the reference's paths both linters agree; under the port's
    the port's linter gives what the reference's gives under its own —
    the one deliberate change, its scope naming ``repro_torch/core/``
    and ``repro_torch/store/`` too."""
    where = path.format(p=package)
    got = port_analyze.lint_source(src, where)
    assert {f.rule for f in got} == rules
    if package == "repro":
        assert _key(got) == _key(ref_analyze.lint_source(src, where))
    else:
        want = ref_analyze.lint_source(src, path.format(p="repro"))
        assert [(f.rule, f.message) for f in got] == \
            [(f.rule, f.message) for f in want]


def test_the_port_lints_clean_under_its_own_scope():
    assert port_analyze.lint_paths([os.path.join(ROOT, "src/repro_torch")]) \
        == []


# --------------------------------------------------------------------------
# clean runs over the in-tree matrices, and the CLI
# --------------------------------------------------------------------------

def _cells(pkg):
    return pkg.validate.smoke_matrix() + pkg.validate.serving_matrix()


@pytest.mark.parametrize("i", range(len(_cells(REF))),
                         ids=[c.label() for c in _cells(REF)])
def test_clean_matrix_cell_in_both_packages(i):
    for pkg in PKGS:
        cell = _cells(pkg)[i]
        assert pkg.analyze.verify_engine(pkg.cache.engine_for(cell)) == []
        micro = cell.scenario.microbatch_size(cell.strategy,
                                              cell.global_batch)
        assert pkg.analyze.verify_cell_memory(
            cell.config(), cell.strategy, micro, cell.seq,
            pkg.core.A40_CLUSTER.chip.hbm_bytes,
            scenario=cell.scenario) == []


@pytest.mark.parametrize("i", range(len(ref_validate.degraded_matrix())),
                         ids=[c.label() for c in
                              ref_validate.degraded_matrix()])
def test_clean_degraded_cell_in_both_packages(i):
    for pkg in PKGS:
        cell = pkg.validate.degraded_matrix()[i]
        assert pkg.analyze.verify_engine(pkg.cache.engine_for(cell)) == []
        assert pkg.analyze.verify_perturbation(cell.perturb,
                                               cell.strategy) == []


def test_frozen_spec_dataclasses_keep_key_paths():
    from repro_torch.core.costmodel import ClusterSpec
    from repro_torch.core.events import Strategy
    from repro_torch.core.perturb import Fault, Perturbation
    from repro_torch.core.scenario import Decode
    for cls, obj in ((Strategy, Strategy(mp=2, pp=2, dp=2, zero1=True)),
                     (Perturbation, Perturbation(faults=(Fault(0, 1),),
                                                 steps=4)),
                     (Decode, Decode(steps=2, context=64))):
        assert cls.__dataclass_params__.frozen
        d = obj.to_dict() if hasattr(obj, "to_dict") else None
        if isinstance(d, dict):
            compared = {f.name for f in dataclasses.fields(cls)
                        if f.compare}
            assert compared <= set(d), cls
    assert ClusterSpec.__dataclass_params__.frozen


def _cli(package, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_VERIFY", None)
    return subprocess.run([sys.executable, "-m", f"{package}.analyze",
                           *args], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)


def test_graph_cli_prints_what_the_reference_prints():
    ref, port = _cli("repro", "graph", "--smoke"), \
        _cli("repro_torch", "graph", "--smoke")
    assert ref.returncode == 0 and port.returncode == 0, port.stderr
    want = ref.stdout.replace("repro.analyze", "repro_torch.analyze")
    assert port.stdout == want
    assert "26 cells + 1 mega-batch program (K=19, T=128) on a40-cluster" \
        in port.stdout
    assert port.stdout.rstrip().endswith("PASS: 0 findings")


def test_lint_cli_passes_over_the_port():
    out = _cli("repro_torch", "lint", "src/repro_torch")
    assert out.returncode == 0, out.stdout
    assert out.stdout.rstrip().endswith("PASS: 0 findings")
