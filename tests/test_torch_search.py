"""The port's strategy search (``repro_torch.search``) against the
reference's on the grid of ``benchmarks/bench_search.py --smoke
--megabatch``: smoke gpt2_345m, 16 devices, global batch 16, seq 128,
microbatches (1, 2, 4, 8), 1f1b and gpipe, with ``a40-cluster`` given to
both packages (their defaults differ: the port's is the H100). Every
score is float64 host arithmetic plus the ``+``/``max`` recurrence, so
the bar is equality: every field of every entry, the stats counters, the
Pareto set and the report text. The port's mega-batch runs on the CPU
(``device="cpu"``, backends ``torch`` and ``numpy``); the card runs it in
``chip_smoke.py``'s ``search`` line.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.configs.base as ref_configs
import repro.core as ref
import repro.search as ref_search
import repro_torch.configs.base as port_configs
import repro_torch.core as port
import repro_torch.search as port_search

GRID = dict(microbatches=(1, 2, 4, 8), schedules=("1f1b", "gpipe"))
SEARCH = (16, 16, 128)
ENTRY_FIELDS = [f.name for f in dataclasses.fields(port_search.SearchEntry)]
STATS_FIELDS = [f.name for f in dataclasses.fields(port_search.SearchStats)
                if f.name != "wall_time_s"]


def cfgs():
    return (ref_configs.smoke_config(ref_configs.get_config("gpt2_345m")),
            port_configs.smoke_config(port_configs.get_config("gpt2_345m")))


def engines(clusters=("A40_CLUSTER",), backend=None, **kw):
    """The same ``SearchEngine`` in both packages; the port's evaluates
    its mega-batch on the CPU with ``backend`` (the reference's ``auto``
    is numpy on a CPU box)."""
    rcfg, pcfg = cfgs()
    r = ref_search.SearchEngine(
        rcfg, clusters=[getattr(ref, c) for c in clusters], **kw)
    p = port_search.SearchEngine(
        pcfg, clusters=[getattr(port, c) for c in clusters],
        device="cpu", megabatch_backend=backend or "auto", **kw)
    return r, p


def entry_tuple(e):
    return tuple(dataclasses.asdict(e.strategy) if f == "strategy"
                 else getattr(e, f) for f in ENTRY_FIELDS)


def assert_same_result(r, p):
    assert [entry_tuple(e) for e in p.entries] == \
        [entry_tuple(e) for e in r.entries]
    assert sorted(p.by_cluster) == sorted(r.by_cluster)
    for name in r.by_cluster:
        assert [entry_tuple(e) for e in p.by_cluster[name]] == \
            [entry_tuple(e) for e in r.by_cluster[name]]
    assert [entry_tuple(e) for e in p.pareto] == \
        [entry_tuple(e) for e in r.pareto]
    assert [getattr(p.stats, f) for f in STATS_FIELDS] == \
        [getattr(r.stats, f) for f in STATS_FIELDS]
    assert {k: v.to_dict() for k, v in p.cluster_specs.items()} == \
        {k: v.to_dict() for k, v in r.cluster_specs.items()}


MODES = {
    # (megabatch, port backend)
    "megabatch-torch": (True, "torch"),
    "megabatch-numpy": (True, "numpy"),
    "per-cell": (False, None),
}


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "no-prune"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_search_result_identical_to_the_reference(mode, prune):
    megabatch, backend = MODES[mode]
    r, p = engines(backend=backend, megabatch=megabatch, prune=prune,
                   check_memory=True)
    rres, pres = r.search(*SEARCH, **GRID), p.search(*SEARCH, **GRID)
    assert_same_result(rres, pres)
    assert pres.stats.megabatch_lanes == (pres.stats.candidates
                                          - pres.stats.pruned_memory
                                          if megabatch else 0)
    assert pres.best() is not None


def test_naive_search_identical_to_the_reference():
    """``share_cache=False``: a fresh provider per candidate, no
    mega-batch — the accounting the paper's Table 3 compares against."""
    r, p = engines(share_cache=False, prune=False, check_memory=True)
    assert_same_result(r.search(*SEARCH, **GRID), p.search(*SEARCH, **GRID))


def test_warm_repeat_search_reuses_the_program_and_profiles_nothing():
    r, p = engines(backend="torch", prune=True, check_memory=True)
    cold = p.search(*SEARCH, **GRID)
    warm = p.search(*SEARCH, **GRID)
    assert warm.stats.provider_evaluations == 0
    assert len(p._megabatch_programs) == 1
    p.megabatch_backend = "numpy"
    again = p.search(*SEARCH, **GRID)
    for res in (warm, again):
        assert [entry_tuple(e) for e in res.entries] == \
            [entry_tuple(e) for e in cold.entries]
    r.search(*SEARCH, **GRID)
    assert_same_result(r.search(*SEARCH, **GRID), warm)


def test_multi_cluster_search_and_pareto():
    r, p = engines(clusters=("A40_CLUSTER", "V5E_POD"), backend="torch",
                   check_memory=True)
    rres, pres = r.search(*SEARCH, **GRID), p.search(*SEARCH, **GRID)
    assert set(pres.by_cluster) == {"a40-cluster", "v5e-pod"}
    assert pres.pareto
    assert port_search.pareto_frontier(pres.pareto) == pres.pareto
    assert_same_result(rres, pres)


def test_the_search_scores_what_simulate_predicts():
    """The best entries equal ``DistSim.simulate()`` of their strategy
    (on the H100 cluster, the port's own target, too)."""
    _, pcfg = cfgs()
    for cluster in (port.A40_CLUSTER, port.H100_CLUSTER):
        res = port_search.SearchEngine(
            pcfg, clusters=cluster, device="cpu").search(*SEARCH, **GRID)
        assert res.stats.megabatch_lanes > 0
        for e in res.ranking()[:4]:
            sim = port.DistSim(pcfg, e.strategy, SEARCH[1], SEARCH[2],
                               port.provider_for(cluster))
            assert e.batch_time == float(sim.simulate().batch_times[0])


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "no-prune"])
def test_report_text_and_json_identical(prune):
    r, p = engines(backend="torch", prune=prune, check_memory=True)
    rres, pres = r.search(*SEARCH, **GRID), p.search(*SEARCH, **GRID)
    rres.stats.wall_time_s = pres.stats.wall_time_s = 1.25
    for top in (10, 3):
        rrep = ref_search.search_report(rres, top=top)
        prep = port_search.search_report(pres, top=top)
        assert json.dumps(prep, sort_keys=True) == \
            json.dumps(rrep, sort_keys=True)
        assert port_search.format_report(prep) == \
            ref_search.format_report(rrep)
    assert port_search.format_table(["a", "bb"], [[1, "x"], [22, "yyy"]]) \
        == ref_search.format_table(["a", "bb"], [[1, "x"], [22, "yyy"]])


def test_grid_search_shim_warns_and_equals_the_reference():
    rcfg, pcfg = cfgs()
    with pytest.warns(DeprecationWarning, match="grid_search"):
        want = ref.grid_search(rcfg, 16, 16, 128,
                               provider=ref.AnalyticalProvider(
                                   ref.A40_CLUSTER))
    with pytest.warns(DeprecationWarning, match="grid_search"):
        got = port.grid_search(pcfg, 16, 16, 128,
                               provider=port.AnalyticalProvider(
                                   port.A40_CLUSTER), device="cpu")
    assert [entry_tuple(e) for e in got] == [entry_tuple(e) for e in want]
    assert all(e.feasible and not e.pruned for e in got)
    assert port.SearchEntry is port_search.SearchEntry


def test_search_defaults_to_the_h100_cluster_and_the_card():
    _, pcfg = cfgs()
    engine = port_search.SearchEngine(pcfg, device="cpu")
    assert [c.name for c in engine.clusters] == ["h100-cluster"]
    assert type(engine.cache.provider(engine.clusters[0])).__name__ == \
        "HopperAnalyticalProvider"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_search.SearchEngine(pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"), \
            pytest.warns(DeprecationWarning, match="grid_search"):
        port.grid_search(pcfg, 16, 16, 128)


IMPORT_ORDERS = [
    ("repro_torch.search", "repro_torch.core"),
    ("repro_torch.core", "repro_torch.search"),
    ("repro_torch.core.search", "repro_torch.search"),
    ("repro_torch.search.engine", "repro_torch.core"),
    ("repro_torch.validate.report", "repro_torch.core"),
    ("repro_torch.store", "repro_torch.search"),
]


@pytest.mark.parametrize("first,second", IMPORT_ORDERS,
                         ids=["-then-".join(o) for o in IMPORT_ORDERS])
def test_the_packages_import_in_either_order(first, second):
    """A fresh interpreter imports ``first`` then ``second``. (The
    reference's ``import repro.search`` in a fresh interpreter raises
    ``ImportError``: core → core.search → search.cache → core.)"""
    code = (f"import {first}, {second}\n"
            "from repro_torch.core import grid_search, SearchEntry\n"
            "from repro_torch.search import SearchEngine, SearchEntry as S\n"
            "assert SearchEntry is S\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.gpu
def test_search_on_the_card_equals_the_reference():
    """Needs a CUDA device and nvcc: the smoke grid scored by K1 on the
    card (cold, then warm), entry for entry the reference's
    (``chip_smoke.py``'s ``search`` line does the same at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels import megabatch_scan as scan
    rcfg, pcfg = cfgs()
    r = ref_search.SearchEngine(rcfg, clusters=ref.A40_CLUSTER)
    p = port_search.SearchEngine(pcfg, clusters=port.A40_CLUSTER)
    assert p.device.type == "cuda"
    before = scan.LAUNCHES
    cold = p.search(*SEARCH, **GRID)
    warm = p.search(*SEARCH, **GRID)
    assert scan.LAUNCHES == before + 2
    want = r.search(*SEARCH, **GRID)
    assert_same_result(want, cold)
    assert [entry_tuple(e) for e in warm.entries] == \
        [entry_tuple(e) for e in cold.entries]
