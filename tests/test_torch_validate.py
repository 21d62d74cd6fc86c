"""The port's validation harness (``repro_torch.validate``: the paper's
§5 predict-vs-replay sweep and the degraded-fleet matrix), its store
``gc`` CLI and its copy of the polling scheduler, against the
reference's live runs on the same cells (not its goldens). Everything
here is float64 host arithmetic copied operation for operation, so the
bar is equality: reports are compared as the ``dumps`` strings both
packages write, field for field.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.configs.base as ref_configs
import repro.core as ref
import repro.core._polling_reference as ref_polling
import repro.validate as ref_validate
import repro.validate.report as ref_report
import repro_torch.configs.base as port_configs
import repro_torch.core as port
import repro_torch.core._polling_reference as port_polling
import repro_torch.validate as port_validate
import repro_torch.validate.report as port_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def sweeps():
    """The smoke matrix swept by both packages on ``a40-cluster``."""
    return (ref_validate.run_sweep(ref_validate.smoke_matrix(),
                                   cluster=ref.A40_CLUSTER, seeds=SEEDS),
            port_validate.run_sweep(port_validate.smoke_matrix(),
                                    cluster=port.A40_CLUSTER, seeds=SEEDS))


def test_matrices_are_the_references():
    for name in ("smoke_matrix", "serving_matrix", "full_matrix",
                 "degraded_matrix"):
        r = getattr(ref_validate, name)()
        p = getattr(port_validate, name)()
        assert len(p) == len(r), name
        assert [c.label() for c in p] == [c.label() for c in r], name


def test_smoke_sweep_equals_the_reference_field_for_field(sweeps):
    r, p = sweeps
    assert len(p.cells) == len(r.cells) == 11
    for a, b in zip(r.cells, p.cells):
        assert b.cell.label() == a.cell.label()
        assert json.dumps(dataclasses.asdict(b.metrics), sort_keys=True) \
            == json.dumps(dataclasses.asdict(a.metrics), sort_keys=True)
        assert (b.passed, b.gates, b.violations, b.seeds) == \
            (a.passed, a.gates, a.violations, a.seeds)
        assert b.pred_batch_time == a.pred_batch_time
        assert b.replay_batch_times == a.replay_batch_times
    assert p.passed == r.passed


def test_dumps_strings_equal(sweeps):
    r, p = sweeps
    text = port_report.dumps(p)
    assert text == ref_report.dumps(r)
    assert port_report.dumps(port_report.load(text)) == text
    assert port_report.format_validation_report(p) == \
        ref_report.format_validation_report(r)


def test_serving_sweep_equals_the_reference():
    r = ref_validate.run_sweep(ref_validate.serving_matrix(),
                               cluster=ref.A40_CLUSTER, seeds=(0, 1))
    p = port_validate.run_sweep(port_validate.serving_matrix(),
                                cluster=port.A40_CLUSTER, seeds=(0, 1))
    assert port_report.dumps(p) == ref_report.dumps(r)


def test_store_backed_sweep_is_bit_identical_to_a_cold_one(sweeps,
                                                          tmp_path):
    _, cold = sweeps
    want = port_report.dumps(cold)
    store = str(tmp_path / "store")
    matrix = port_validate.smoke_matrix()
    first = port_validate.run_sweep(matrix, cluster=port.A40_CLUSTER,
                                    seeds=SEEDS, store=store)
    provider = port.AnalyticalProvider(port.A40_CLUSTER)
    warm = port_validate.run_sweep(matrix, provider=provider, seeds=SEEDS,
                                   store=store)
    assert provider.stats.evaluations == 0          # all from the store
    assert port_report.dumps(first) == port_report.dumps(warm) == want


@pytest.fixture
def spawn_workers(monkeypatch):
    """This session holds the reference beside the port, and forking a
    process whose JAX thread pools run can deadlock: its workers are
    spawned, as the reference's executor spawns while jax is loaded."""
    import multiprocessing
    from repro_torch.validate import executor
    monkeypatch.setattr(executor, "_mp_context",
                        lambda: multiprocessing.get_context("spawn"))


def test_two_jobs_equal_serial(sweeps, spawn_workers):
    _, serial = sweeps
    par = port_validate.run_sweep(port_validate.smoke_matrix(),
                                  cluster=port.A40_CLUSTER, seeds=SEEDS,
                                  jobs=2)
    assert port_report.dumps(par) == port_report.dumps(serial)


def test_workers_spawn_once_the_card_is_initialized(monkeypatch):
    """A forked child of a process that has initialized CUDA cannot use
    the card, so the executor spawns then, and forks otherwise."""
    from repro_torch.validate import executor
    if "fork" not in __import__("multiprocessing").get_all_start_methods():
        pytest.skip("no fork on this platform")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert executor._mp_context().get_start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert executor._mp_context().get_start_method() == "spawn"


def test_run_degraded_equals_the_reference():
    r = ref_validate.run_degraded(ref_validate.degraded_matrix())
    p = port_validate.run_degraded(port_validate.degraded_matrix())
    assert p.passed and r.passed
    assert json.dumps(p.to_dict(), sort_keys=True) == \
        json.dumps(r.to_dict(), sort_keys=True)
    assert port_validate.format_degraded_report(p) == \
        ref_validate.format_degraded_report(r)
    for res in p.cells:
        assert port_validate.structural_violations(
            res.cell, res.run, res.baseline_total) == res.violations == []


def _warm_store(path, pkg):
    """A store warmed by a two-cell sweep of ``pkg``, flushed twice so
    that gc has shards to compact."""
    core, validate = {"ref": (ref, ref_validate),
                      "port": (port, port_validate)}[pkg]
    matrix = validate.smoke_matrix()
    validate.run_sweep(matrix[:1], cluster=core.A40_CLUSTER, seeds=(0,),
                       store=str(path))
    validate.run_sweep(matrix[1:3], cluster=core.A40_CLUSTER, seeds=(0,),
                       store=str(path))


def _gc(module, path, *flags):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-m", module, "gc", str(path),
                           *flags], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("flags", [("--json",), ()], ids=["json", "text"])
def test_store_gc_cli_output_equals_the_reference(tmp_path, flags):
    """Each package's ``gc`` over a copy of a store its own sweep wrote
    (the port keeps its builds apart from the reference's), both written
    from the same cells: the same compaction, the same report."""
    for pkg in ("ref", "port"):
        _warm_store(tmp_path / pkg, pkg)
    r = _gc("repro.store", tmp_path / "ref", *flags)
    p = _gc("repro_torch.store", tmp_path / "port", *flags)
    assert p.replace(str(tmp_path / "port"), "<store>") == \
        r.replace(str(tmp_path / "ref"), "<store>")
    if flags:
        stats = json.loads(p)
        assert stats["shards_after"] == 1 and stats["builds_kept"] > 0
    again = _gc("repro_torch.store", tmp_path / "port", "--json")
    assert json.loads(again)["shards_after"] == 1   # idempotent


def test_store_gc_cli_on_one_store_written_by_the_reference(tmp_path):
    """Both CLIs over copies of the same store, warmed by the reference:
    the same event compaction. The builds differ by design: the port
    counts only its own (``builds_torch/``) and neither opens nor
    deletes the reference's pickles, which the reference's gc still
    keeps afterwards."""
    _warm_store(tmp_path / "a", "ref")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    r = json.loads(_gc("repro.store", tmp_path / "a", "--json"))
    p = json.loads(_gc("repro_torch.store", tmp_path / "b", "--json"))
    assert r["builds_kept"] > 0 and p["builds_kept"] == 0
    assert p["builds_dropped"] == r["builds_dropped"] == 0
    del r["builds_kept"], p["builds_kept"]
    assert p == r
    after = json.loads(_gc("repro.store", tmp_path / "b", "--json"))
    assert after["builds_kept"] > 0 and after["builds_dropped"] == 0


def test_gc_cli_keeps_a_port_store_serving(tmp_path):
    _warm_store(tmp_path, "port")
    _gc("repro_torch.store", tmp_path, "--json")
    provider = port.AnalyticalProvider(port.A40_CLUSTER)
    port_validate.run_sweep(port_validate.smoke_matrix()[:3],
                            provider=provider, seeds=(0,),
                            store=str(tmp_path))
    assert provider.stats.evaluations == 0


POLLING_STRATS = [
    dict(mp=1, pp=2, dp=2, microbatches=4),
    dict(mp=1, pp=4, dp=1, microbatches=8, schedule="gpipe"),
    dict(mp=2, pp=2, dp=1, microbatches=4, schedule="interleaved", vpp=2),
    dict(mp=1, pp=1, dp=4, microbatches=2),
    dict(mp=2, pp=2, dp=2, microbatches=4, zero1=True),
    dict(mp=1, pp=2, dp=2, microbatches=4, schedule="pipedream"),
    dict(mp=1, pp=4, dp=2, microbatches=8, schedule="interleaved", vpp=3),
    dict(mp=1, pp=2, dp=2, microbatches=4, grad_compress=0.25),
]


def _key(tl):
    return sorted((a.device, a.name, a.kind, a.start, a.end, a.stage,
                   a.micro) for a in tl.activities)


@pytest.mark.parametrize("kw", POLLING_STRATS,
                         ids=[f"{i}-{kw.get('schedule', '1f1b')}"
                              for i, kw in enumerate(POLLING_STRATS)])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_polling_reference_equals_the_references(kw, smoke):
    """The two polling schedulers on the cells of ``tests/test_engine.py``
    (the schedulers themselves: the reference's engine-vs-polling test
    is red, so the engine is not in this comparison)."""
    out = []
    for core, configs, polling in ((ref, ref_configs, ref_polling),
                                   (port, port_configs, port_polling)):
        cfg = configs.get_config("gpt2_345m")
        if smoke:
            cfg = configs.smoke_config(cfg)
        strat = core.Strategy(**kw)
        gb = strat.dp * strat.microbatches * 2
        out.append(polling.construct_timeline_polling(
            cfg, strat, gb, 128, core.AnalyticalProvider(core.A40_CLUSTER)))
    r, p = out
    assert p.n_devices == r.n_devices
    assert _key(p) == _key(r)
    assert p.batch_time == r.batch_time


@pytest.mark.gpu
def test_two_jobs_after_cuda_is_initialized_equal_serial():
    """Needs a CUDA device: once the parent has initialized CUDA the
    workers are spawned (a forked child could not use the card), and
    the sweep still equals the serial one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.validate import executor
    torch.zeros(1, device="cuda")
    assert torch.cuda.is_initialized()
    assert executor._mp_context().get_start_method() == "spawn"
    matrix = port_validate.smoke_matrix()[:4]
    serial = port_validate.run_sweep(matrix, cluster=port.A40_CLUSTER,
                                     seeds=(0, 1))
    par = port_validate.run_sweep(matrix, cluster=port.A40_CLUSTER,
                                  seeds=(0, 1), jobs=2)
    assert port_report.dumps(par) == port_report.dumps(serial)
