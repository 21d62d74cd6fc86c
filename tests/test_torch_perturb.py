"""The port's perturbation axis (``repro_torch.core.perturb``: stragglers
and faults) against the reference's, case for case with
``tests/test_perturb.py``. Every result is float64 host arithmetic
copied operation for operation, so the bar is equality: a degraded run
is compared through its ``to_dict``, a batch time bit for bit. Both
packages get the same cluster (``A40_CLUSTER``) explicitly, since their
defaults differ (the port's is the H100). The straggler-plane mega-batch
runs on the CPU ``torch`` backend and on numpy; the card runs it in
``chip_smoke.py``'s perturbed serve.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs.base as ref_configs
import repro.core as ref
import repro.core.perturb as ref_perturb
import repro.core.scenario as ref_scn
import repro.store as ref_store
import repro.store.profile_store as ref_ps
import repro.train.checkpoint as ref_ckpt
import repro.validate as ref_validate
import repro_torch.configs.base as port_configs
import repro_torch.core as port
import repro_torch.core.perturb as port_perturb
import repro_torch.core.scenario as port_scn
import repro_torch.store as port_store
import repro_torch.store.profile_store as port_ps
import repro_torch.train.checkpoint as port_ckpt
import repro_torch.validate as port_validate
from repro_torch.telemetry import COUNTS

PKGS = {"ref": (ref, ref_configs, ref_scn, ref_perturb),
        "port": (port, port_configs, port_scn, port_perturb)}


def sim(pkg, mp=1, pp=2, dp=2, m=4, gb=16, scenario=None):
    """``tests/test_perturb.py``'s ``_sim`` in package ``pkg``, on the
    A40 cluster."""
    core, configs, scn, _ = PKGS[pkg]
    return core.DistSim(
        configs.get_config("gpt2_345m"),
        core.Strategy(mp=mp, pp=pp, dp=dp, microbatches=m,
                      schedule="1f1b"), gb, 512,
        core.AnalyticalProvider(core.A40_CLUSTER),
        scenario=scenario if scenario is not None else scn.TRAIN)


def both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn("ref"), fn("port")


def P(pkg, stragglers=(), faults=(), **kw):
    """A :class:`Perturbation` of ``pkg`` from plain tuples:
    ``stragglers`` as ``(rank, factor[, window])``, ``faults`` as
    ``(rank, at_step[, detect_s])``."""
    core = PKGS[pkg][0]
    return core.Perturbation(
        stragglers=tuple(core.Straggler(*s) for s in stragglers),
        faults=tuple(core.Fault(*f) for f in faults), **kw)


def same_json(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ------------------------ spec validation ------------------------

BAD_SPECS = [
    ("Straggler", dict(rank=-1, factor=1.5)),
    ("Straggler", dict(rank=0, factor=0.0)),
    ("Straggler", dict(rank=0, factor=1.5, window=(4, 2))),
    ("Fault", dict(rank=0, at_step=-1)),
    ("Perturbation", dict(steps=0)),
]


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("kind,kw", BAD_SPECS,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(BAD_SPECS)])
def test_spec_validation(pkg, kind, kw):
    with pytest.raises(ValueError):
        getattr(PKGS[pkg][0], kind)(**kw)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fault_specs_validated_and_sorted(pkg):
    with pytest.raises(ValueError):                 # duplicate fault rank
        P(pkg, faults=((0, 1), (0, 3)), steps=8)
    with pytest.raises(ValueError):                 # fault outside run
        P(pkg, faults=((0, 9),), steps=8)
    p = P(pkg, faults=((1, 5), (0, 2)), steps=8)
    assert [f.at_step for f in p.faults] == [2, 5]
    core = PKGS[pkg][0]
    assert core.Straggler(0, 2.0, window=(1, 3)).covers(2)
    assert not core.Straggler(0, 2.0, window=(1, 3)).covers(3)
    assert core.Straggler(0, 2.0).covers(10 ** 9)  # OPEN window


def test_speed_grid_layout_and_range_match_the_reference():
    def grids(pkg):
        strat = PKGS[pkg][0].Strategy(mp=2, pp=2, dp=2, microbatches=4)
        out = [P(pkg, stragglers=((2, 1.5),)).speed_grid(strat),
               P(pkg, stragglers=((2, 1.5), (2, 2.0))).speed_grid(strat)]
        with pytest.raises(ValueError, match="out of range"):
            P(pkg, stragglers=((8, 2.0),)).speed_grid(strat)
        return out

    r, p = both(grids)
    assert p[0].shape == (2, 2) and p[0][0, 1] == 1.5
    assert p[1][0, 1] == 3.0                        # stacked multiply
    for a, b in zip(r, p):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_serde_roundtrip_and_cross_package():
    def spec(pkg):
        return P(pkg, stragglers=((1, 1.5, (2, 6)), (3, 2.0)),
                 faults=((2, 5, 0.5),), steps=12, save_every=3,
                 replan_s=1.0)

    r, p = both(spec)
    assert port.perturbation_from_dict(p.to_dict()) == p
    assert port.perturbation_from_dict(None) is None
    assert json.loads(json.dumps(p.to_dict())) == p.to_dict()
    same_json(p.to_dict(), r.to_dict())
    assert port.perturbation_from_dict(r.to_dict()) == p
    assert p.label() == r.label() == "slow1x1.5@2:6+slow3x2+fault2@5"
    assert port.Perturbation().label() == "clean"


# ------------------------ bit-identity (differential) ------------------------

def test_zero_perturbation_is_bit_identical():
    def times(pkg):
        eng = sim(pkg).engine()
        empty = P(pkg, steps=1)
        seeds = [0, 1, 2]
        kw = dict(jitter_sigma=0.025, straggler_sigma=0.01)
        out = [eng.run_batched(None).batch_times,
               eng.run_batched(None, perturb=empty).batch_times,
               eng.run_batched(seeds, **kw).batch_times,
               eng.run_batched(seeds, perturb=empty, **kw).batch_times,
               np.asarray([eng.run(jitter_sigma=0.025, seed=1).batch_time,
                           eng.run(jitter_sigma=0.025, seed=1,
                                   perturb=empty).batch_time])]
        return out

    r, p = both(times)
    assert np.array_equal(p[0], p[1]) and np.array_equal(p[2], p[3])
    assert p[4][0] == p[4][1]
    for a, b in zip(r, p):
        assert np.array_equal(a, b)


def test_perturbed_run_matches_run_batched():
    def times(pkg):
        eng = sim(pkg).engine()
        p = P(pkg, stragglers=((1, 1.7),))
        return [eng.run(perturb=p).batch_time,
                float(eng.run_batched(None, perturb=p).batch_times[0]),
                eng.run(jitter_sigma=0.025, seed=3, perturb=p).batch_time,
                float(eng.run_batched([3], jitter_sigma=0.025,
                                      perturb=p).batch_times[0])]

    r, p = both(times)
    assert p[0] == p[1] and p[2] == p[3]
    assert p == r


def test_straggler_monotone_in_factor():
    def times(pkg):
        eng = sim(pkg).engine()
        out = [float(eng.run_batched(None).batch_times[0])]
        for f in (1.0, 1.25, 1.5, 2.0):
            p = P(pkg, stragglers=((1, f), (3, f)))
            out.append(float(eng.run_batched(None, perturb=p)
                             .batch_times[0]))
        return out

    r, p = both(times)
    assert p[1] == p[0]                             # exact, not approx
    assert all(a < b for a, b in zip(p[1:], p[2:]))
    assert p == r


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_engine_rejects_faults(pkg):
    eng = sim(pkg).engine()
    p = P(pkg, faults=((0, 1),), steps=4)
    with pytest.raises(ValueError, match="run level"):
        eng.run(perturb=p)
    with pytest.raises(ValueError, match="run level"):
        eng.run_batched(None, perturb=p)


# ------------------------ megabatch ------------------------

MEGA_STRATS = [dict(mp=1, pp=2, dp=2, m=4), dict(mp=2, pp=4, dp=1, m=8),
               dict(mp=1, pp=4, dp=1, m=4)]


def mega_engines(pkg):
    return [sim(pkg, **kw).engine() for kw in MEGA_STRATS]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_megabatch_perturbed_bit_identical_to_engine(backend):
    """The straggler plane: every lane equals ``engine.run(perturb=p)``
    and the reference's numpy program, on the CPU ``torch`` backend and
    on numpy."""
    def uniform(pkg):      # ranks 1 and 3: device 1 of both replicas
        return P(pkg, stragglers=((1, 1.5), (3, 1.5)))

    engines = mega_engines("port")[:1]
    p = uniform("port")
    got = port.MegaBatch(engines, perturb=p, device="cpu").predict(backend)
    assert float(got.batch_times[0]) == engines[0].run(perturb=p).batch_time
    clean = port.MegaBatch(engines, device="cpu").predict(backend)
    assert float(clean.batch_times[0]) == \
        float(engines[0].run_batched(None).batch_times[0])
    want = ref.MegaBatch(mega_engines("ref")[:1],
                         perturb=uniform("ref")).predict("numpy")
    assert np.array_equal(got.batch_times, want.batch_times)
    assert np.array_equal(got.bubble_fractions, want.bubble_fractions)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_megabatch_lanes_under_one_straggler_plane(backend):
    """A heterogeneous K = 3 program under a perturbation that is
    uniform across DP for every lane (a straggling device of replica 0
    on dp == 1 lanes; pipeline device 1 of each replica on dp == 2)."""
    def pert(pkg):
        return P(pkg, stragglers=((0, 1.5),))

    r_eng = mega_engines("ref")[1:]
    p_eng = mega_engines("port")[1:]
    got = port.MegaBatch(p_eng, perturb=pert("port"),
                         device="cpu").predict(backend)
    want = ref.MegaBatch(r_eng, perturb=pert("ref")).predict("numpy")
    assert np.array_equal(got.batch_times, want.batch_times)
    assert [float(t) for t in got.batch_times] == \
        [e.run(perturb=pert("port")).batch_time for e in p_eng]
    clean = port.MegaBatch(p_eng, device="cpu").predict(backend)
    assert (got.batch_times > clean.batch_times).all()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_megabatch_rejects_nonuniform_and_faults(pkg):
    core = PKGS[pkg][0]
    eng = sim(pkg).engine()
    dev = {} if pkg == "ref" else {"device": "cpu"}
    with pytest.raises(ValueError, match="uniform across DP"):
        core.MegaBatch([eng], perturb=P(pkg, stragglers=((1, 1.5),)),
                       **dev).predict("numpy")
    with pytest.raises(ValueError, match="run level"):
        core.MegaBatch([eng], perturb=P(pkg, faults=((0, 1),), steps=4),
                       **dev)
    with pytest.raises(ValueError, match="run level"):
        core.megabatch_predict([eng], "numpy",
                               perturb=P(pkg, faults=((0, 1),), steps=4),
                               **dev)


# ------------------------ fault splice ------------------------

def test_fault_recovery_splice():
    def run(pkg):
        return sim(pkg).simulate(perturb=P(
            pkg, faults=((3, 6, 0.5),), steps=12, save_every=4,
            replan_s=1.5))

    r, run_ = both(run)
    assert run_.steps == 12 and len(run_.recoveries) == 1
    rec = run_.recoveries[0]
    assert (rec.ckpt_step, rec.lost_steps, rec.survivors) == (4, 2, 3)
    assert rec.plan.model == 2 and rec.plan.data == 1
    assert run_.final_strategy.dp == 1
    assert run_.effective_global_batch == 8
    assert [e.kind for e in rec.events] == \
        ["detect", "restore", "replan", "recompute"]
    durs = {e.kind: float(e.duration[0]) for e in rec.events}
    assert durs["detect"] == 0.5 and durs["replan"] == 1.5
    assert durs["restore"] > 0
    expected = (6 * run_.baseline_step_time + rec.recovery_times
                + 6 * run_.post_failure_step_time)
    np.testing.assert_allclose(run_.total_times, expected, rtol=1e-12)
    tl = run_.timeline(0)
    assert tl[0][1] == 0.0
    assert all(a[2] == b[1] for a, b in zip(tl, tl[1:]))
    assert tl == r.timeline(0)
    assert np.array_equal(run_.total_times, r.total_times)
    same_json(run_.to_dict(), r.to_dict())


def test_post_replan_runs_clean_of_stragglers():
    def run(pkg):
        return sim(pkg).simulate(perturb=P(
            pkg, stragglers=((1, 3.0),), faults=((3, 4),), steps=8,
            save_every=4))

    r, p = both(run)
    post = [s for s in p.segments if s.start >= 4]
    assert post and all(not s.stragglers for s in post)
    pre = [s for s in p.segments if s.stop <= 4]
    assert any(float(s.step_times[0]) > float(p.baseline_step_time[0])
               for s in pre)
    same_json(p.to_dict(), r.to_dict())


def test_straggler_window_cuts_segments():
    def runs(pkg):
        s = sim(pkg)
        return (s.simulate(perturb=P(pkg, stragglers=((1, 2.0, (2, 6)),),
                                     steps=8)),
                s.simulate(perturb=P(
                    pkg, stragglers=((1, 2.0, (2, PKGS[pkg][3].OPEN)),),
                    steps=8)))

    (r1, r2), (p1, p2) = both(runs)
    assert [(s.start, s.stop) for s in p1.segments] == \
        [(0, 2), (2, 6), (6, 8)]
    t0, t1, t2 = (float(s.step_times[0]) for s in p1.segments)
    assert t0 == t2 and t1 > t0
    assert [(s.start, s.stop) for s in p2.segments] == [(0, 2), (2, 8)]
    same_json(p1.to_dict(), r1.to_dict())
    same_json(p2.to_dict(), r2.to_dict())


def test_zero1_shrinks_restore_read():
    def manifests(pkg):
        s = sim(pkg)
        stages = s.engine().stages
        return (PKGS[pkg][3].restore_manifest(stages, s.strategy, 4),
                PKGS[pkg][3].restore_manifest(
                    stages, dataclasses.replace(s.strategy, zero1=True), 4))

    (r_plain, r_z1), (p_plain, p_z1) = both(manifests)
    assert port_ckpt.manifest_nbytes(p_z1) < \
        port_ckpt.manifest_nbytes(p_plain)
    same_json(p_plain, r_plain)
    same_json(p_z1, r_z1)
    assert port_ckpt.manifest_nbytes(p_z1) == \
        ref_ckpt.manifest_nbytes(r_z1)


def test_double_fault_replans_twice():
    def run(pkg):
        return sim(pkg, mp=1, pp=1, dp=4, m=2).simulate(perturb=P(
            pkg, faults=((0, 3), (2, 7)), steps=10, save_every=4))

    r, p = both(run)
    assert [x.survivors for x in p.recoveries] == [3, 2]
    assert [x.plan.data for x in p.recoveries] == [2, 2]
    assert p.final_strategy.dp == 2 and p.effective_global_batch == 8
    assert p.steps_lost == r.steps_lost == 6
    same_json(p.to_dict(), r.to_dict())


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_unrecoverable_and_invalid_faults_raise(pkg):
    scn = PKGS[pkg][2]
    with pytest.raises(ValueError, match="unrecoverable"):
        sim(pkg, mp=1, pp=2, dp=1, m=4).simulate(
            perturb=P(pkg, faults=((0, 1),), steps=4))
    with pytest.raises(ValueError, match="out of range"):
        sim(pkg).simulate(perturb=P(pkg, faults=((9, 1),), steps=4))
    with pytest.raises(ValueError, match="training-run"):
        sim(pkg, gb=8, scenario=scn.Decode(steps=4)).simulate(
            perturb=P(pkg, faults=((0, 1),), steps=4))
    with pytest.raises(ValueError, match="scenario"):
        sim(pkg).simulate(perturb=P(pkg, steps=4),
                          scenario=scn.Decode(steps=4))


def test_seeded_degraded_run_has_lanes():
    def run(pkg):
        return sim(pkg).simulate(perturb=P(
            pkg, stragglers=((1, 1.5),), faults=((3, 4),), steps=8,
            save_every=4), seeds=(0, 1))

    r, p = both(run)
    assert p.total_times.shape == (2,) and p.seeds == [0, 1]
    assert float(p.total_times[0]) != float(p.total_times[1])
    d = p.to_dict()
    assert json.loads(json.dumps(d)) == d
    same_json(d, r.to_dict())


@pytest.mark.parametrize("index", range(7))
def test_simulate_on_the_degraded_smoke_cells_equals_the_reference(index):
    """``simulate(perturb=)`` on each cell of ``degraded_matrix()``,
    against the reference's live ``DegradedRun`` (not its goldens)."""
    def run(pkg):
        validate = {"ref": ref_validate, "port": port_validate}[pkg]
        cells = validate.degraded_matrix()
        assert len(cells) == 7
        cell = cells[index]
        core, configs = PKGS[pkg][:2]
        cfg = configs.get_config(cell.arch)
        if cell.smoke:
            cfg = configs.smoke_config(cfg)
        s = core.DistSim(cfg, cell.strategy, cell.global_batch, cell.seq,
                         core.AnalyticalProvider(core.A40_CLUSTER))
        return s.simulate(perturb=cell.perturb, seeds=(0, 1))

    r, p = both(run)
    assert type(p) is port.DegradedRun
    same_json(p.to_dict(), r.to_dict())


# ------------------------ address/serialization stability ------------------------

def test_build_keys_carry_no_perturb_field():
    def key_json(pkg):
        s = sim(pkg)
        ps = {"ref": ref_ps, "port": port_ps}[pkg]
        return ps.build_key_json((s.cfg, s.strategy, 2, 512))

    r, p = both(key_json)
    assert "perturb" not in p and p == r


def test_serve_query_serialization_unchanged_when_clean():
    def dicts(pkg):
        core, store = PKGS[pkg][0], {"ref": ref_store,
                                     "port": port_store}[pkg]
        q = store.ServeQuery("gpt2_345m", core.Strategy(
            mp=1, pp=2, dp=2, microbatches=4), cluster="a40-cluster")
        qp = dataclasses.replace(
            q, perturb=P(pkg, stragglers=((1, 1.5), (3, 1.5))))
        assert store.ServeQuery.from_dict(q.to_dict()) == q
        assert store.ServeQuery.from_dict(
            json.loads(json.dumps(qp.to_dict()))) == qp
        return q.to_dict(), qp.to_dict()

    (rq, rqp), (pq, pqp) = both(dicts)
    assert "perturb" not in pq
    same_json(pq, rq)
    same_json(pqp, rqp)
    assert port_store.ServeQuery.from_dict(
        json.loads(json.dumps(rqp))).perturb == \
        port.Perturbation(stragglers=(port.Straggler(1, 1.5),
                                      port.Straggler(3, 1.5)))


def test_serve_answers_perturbed_queries(tmp_path):
    def answers(pkg):
        core, store = PKGS[pkg][0], {"ref": ref_store,
                                     "port": port_store}[pkg]
        dev = {} if pkg == "ref" else {"device": "cpu"}
        server = core.DistSim.serve(str(tmp_path / pkg), **dev)
        q = store.ServeQuery("gpt2_345m", core.Strategy(
            mp=1, pp=2, dp=2, microbatches=4), cluster="a40-cluster")
        p = P(pkg, stragglers=((1, 1.5), (3, 1.5)))
        clean, slow = server.answer_batch(
            [q, dataclasses.replace(q, perturb=p)])
        s = sim(pkg)
        assert clean.batch_time == float(s.simulate().batch
                                         .batch_times[0])
        assert slow.batch_time == s.engine().run(perturb=p).batch_time
        return clean.to_dict(), slow.to_dict()

    (rc, rs), (pc, ps) = both(answers)
    assert ps["batch_time"] > pc["batch_time"]
    same_json(pc, rc)
    same_json(ps, rs)


@pytest.mark.gpu
def test_perturbed_megabatch_on_the_card_equals_the_reference():
    """Needs a CUDA device and nvcc: a straggler-plane program scored by
    K1 on the card, bit for bit the reference's numpy program
    (``chip_smoke.py``'s perturbed serve does the same at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")

    def pert(pkg):
        return P(pkg, stragglers=((0, 1.5),))

    before = COUNTS.get("k1.launches", 0)
    got = port.MegaBatch(mega_engines("port")[1:],
                         perturb=pert("port")).predict("cuda")
    assert COUNTS.get("k1.launches", 0) == before + 1
    want = ref.MegaBatch(mega_engines("ref")[1:],
                         perturb=pert("ref")).predict("numpy")
    assert np.array_equal(got.batch_times, want.batch_times)
    assert np.array_equal(got.bubble_fractions, want.bubble_fractions)
