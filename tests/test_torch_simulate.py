"""The port's ``DistSim.simulate()`` against the reference's, bit for
bit, with the cluster presets both packages hold unchanged
(``A40_CLUSTER``, ``V5E_POD``) passed explicitly. Everything on this
path is float64 host arithmetic copied operation for operation, so the
bar is equality, not a tolerance. The H100 preset exists only in the
port and is tested structurally.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref
import repro.configs.base as ref_configs
import repro.core.scenario as ref_scn
import repro_torch.core as port
import repro_torch.configs.base as port_configs
import repro_torch.core.scenario as port_scn
from repro_torch.core.hw import H100, tensor_core_efficiency

SCHEDULES = {
    "1f1b": dict(mp=1, pp=2, dp=2, microbatches=4),
    "gpipe": dict(mp=2, pp=2, dp=1, microbatches=4, schedule="gpipe"),
    "interleaved": dict(mp=1, pp=2, dp=2, microbatches=4,
                        schedule="interleaved", vpp=2),
    "pipedream": dict(mp=1, pp=2, dp=1, microbatches=4,
                      schedule="pipedream"),
}
# (arch, reduce with smoke_config)
MODELS = [("gpt2_345m", False), ("bert_large", False), ("t5_large", False),
          ("qwen3_moe_30b_a3b", True)]


def sims(arch, smoke, kw, cluster, global_batch=None, seq=128,
         scenario=None):
    """The same simulation in both packages."""
    out = []
    for pkg, configs, scn in ((ref, ref_configs, ref_scn),
                              (port, port_configs, port_scn)):
        cfg = configs.get_config(arch)
        if smoke:
            cfg = configs.smoke_config(cfg)
        strat = pkg.Strategy(**kw)
        gb = global_batch or strat.dp * strat.microbatches * 2
        sc = scn.TRAIN
        if scenario is not None:
            kind, skw = scenario
            sc = getattr(scn, kind)(**skw)
        spec = getattr(pkg, cluster)
        out.append(pkg.DistSim(cfg, strat, gb, seq,
                               pkg.AnalyticalProvider(spec), scenario=sc))
    return out


def assert_same(a, b):
    assert np.array_equal(a.batch_times, b.batch_times)
    assert np.array_equal(a.utilization(), b.utilization())
    assert np.array_equal(a.bubble_fraction(), b.bubble_fraction())
    assert np.array_equal(a.throughput_tokens(), b.throughput_tokens())
    assert a.seeds == b.seeds and a.mode == b.mode


@pytest.mark.parametrize("cluster", ["A40_CLUSTER", "V5E_POD"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("arch,smoke", MODELS)
def test_train_predict_bit_identical(arch, smoke, schedule, cluster):
    r, p = sims(arch, smoke, SCHEDULES[schedule], cluster)
    assert_same(r.simulate(), p.simulate())
    assert r.profiling_report() == p.profiling_report()


SERVING = [
    ("Prefill", {}),
    ("Decode", {}),
    ("Decode", dict(steps=4, context=4096)),
    ("Decode", dict(steps=3, arrivals=(0.0, 1e-4, 2e-4))),
]


@pytest.mark.parametrize("cluster", ["A40_CLUSTER", "V5E_POD"])
@pytest.mark.parametrize("scenario", SERVING,
                         ids=["prefill", "decode", "decode-ctx",
                              "decode-arrivals"])
@pytest.mark.parametrize("arch,smoke", MODELS[:2] + MODELS[3:])
def test_serving_predict_bit_identical(arch, smoke, scenario, cluster):
    kw = dict(mp=2, pp=2, dp=2, microbatches=4)
    r, p = sims(arch, smoke, kw, cluster, global_batch=16, seq=256,
                scenario=scenario)
    assert_same(r.simulate(), p.simulate())


def test_scenario_override_per_call():
    r, p = sims("gpt2_345m", False, SCHEDULES["1f1b"], "A40_CLUSTER")
    assert_same(r.simulate(scenario=ref_scn.Decode(steps=3)),
                p.simulate(scenario=port_scn.Decode(steps=3)))


def test_full_width_gpt_145b_paper_strategy():
    """The paper's 8M16P1D at the model's full width (80 layers,
    d_model 12288, d_ff 49152)."""
    kw = dict(mp=8, pp=16, dp=1, microbatches=16)
    for cluster in ("A40_CLUSTER", "V5E_POD"):
        r, p = sims("gpt_145b", False, kw, cluster, global_batch=16,
                    seq=2048)
        assert_same(r.simulate(), p.simulate())


@pytest.mark.parametrize("seeds", [0, (0, 1, 2), (7,)])
def test_replay_lanes_bit_identical_per_seed(seeds):
    r, p = sims("gpt2_345m", False, SCHEDULES["1f1b"], "A40_CLUSTER")
    kw = dict(jitter_sigma=0.03, straggler_sigma=0.02, clock_sigma=1e-5)
    a, b = r.simulate(seeds=seeds, **kw), p.simulate(seeds=seeds, **kw)
    assert_same(a, b)
    for i in range(len(a)):
        assert a.result(i).batch_time == b.result(i).batch_time
        assert a.result(i).utilization == b.result(i).utilization


def test_copied_presets_are_unchanged():
    for name in ("V5E_POD", "A40_CLUSTER"):
        assert getattr(port, name).to_dict() == getattr(ref, name).to_dict()
    assert set(port.CLUSTERS) == set(ref.CLUSTERS) | {"h100-node",
                                                      "h100-cluster"}
    assert sorted(port_configs.list_archs()) == \
        sorted(ref_configs.list_archs())
    for arch in ref_configs.list_archs():
        assert dataclasses.asdict(port_configs.get_config(arch)) == \
            dataclasses.asdict(ref_configs.get_config(arch))


def test_perturb_is_refused_not_ignored():
    """``simulate(perturb=)`` refuses a per-call override it cannot
    compose with, and otherwise models the perturbation: a degraded
    run, slower than the clean step (``tests/test_torch_perturb.py``
    holds it against the reference)."""
    _, p = sims("gpt2_345m", False, SCHEDULES["1f1b"], "A40_CLUSTER")
    slow = port.Perturbation(stragglers=(port.Straggler(1, 2.0),),
                             steps=2)
    with pytest.raises(ValueError, match="scenario"):
        p.simulate(perturb=slow, scenario=port_scn.Decode(steps=4))
    run = p.simulate(perturb=slow)
    assert isinstance(run, port.DegradedRun)
    assert float(run.total_times[0]) > \
        2 * float(p.simulate().batch_times[0])


# ---- the H100 target: structural only (no reference has it) ----

def h100_sim(kw, global_batch=64, arch="gpt2_345m", seq=512):
    cfg = port_configs.get_config(arch)
    return port.DistSim(cfg, port.Strategy(**kw), global_batch, seq)


def test_h100_is_the_default_target():
    sim = h100_sim(dict(mp=1, pp=2, dp=2, microbatches=4))
    assert sim.provider.cluster is port.H100_CLUSTER
    assert type(sim.provider) is port.HopperAnalyticalProvider
    assert type(port.provider_for(port.A40_CLUSTER)) is \
        port.AnalyticalProvider
    assert port.H100_CLUSTER.chip is H100
    assert port.H100_NODE.devices_per_island == 8


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_h100_batch_time_not_increasing_in_dp(pp):
    """Fixed global batch, fixed microbatch size: more replicas, fewer
    microbatches each — the batch never gets slower."""
    times = []
    for dp in (1, 2, 4, 8):
        sim = h100_sim(dict(mp=1, pp=pp, dp=dp, microbatches=64 // dp))
        bt = sim.simulate().batch_time
        assert np.isfinite(bt) and bt > 0
        times.append(bt)
    assert all(b <= a for a, b in zip(times, times[1:])), times


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (64, 64, 64), (127, 129, 65),
                                   (4096, 4096, 4096),
                                   (32768, 6144, 12288)])
def test_tensor_core_efficiency_is_a_fraction(m, n, k):
    e = tensor_core_efficiency(m, n, k)
    assert 0.02 <= e <= 0.80
    # a large aligned GEMM beats a tiny one
    assert tensor_core_efficiency(8192, 8192, 8192) > \
        tensor_core_efficiency(8, 8, 8)


#: the five deprecated wrappers' calls: (method, positional args,
#: keyword args); the replays with noise on every knob
WRAPPER_NOISE = dict(jitter_sigma=0.03, straggler_sigma=0.02,
                     clock_sigma=1e-5)
WRAPPERS = {
    "predict": ("predict", (), {}),
    "predict-positions": ("predict", (), {"positions": "own"}),
    "replay": ("replay", (), {}),
    "replay-seed-noise": ("replay", (3,), WRAPPER_NOISE),
    "predict_batched": ("predict_batched", (), {}),
    "replay_batched": ("replay_batched", ((0, 1, 2),), WRAPPER_NOISE),
    "predict_and_replay": ("predict_and_replay", (), {}),
    "predict_and_replay-seeds": ("predict_and_replay", ((4, 5),),
                                 WRAPPER_NOISE),
    "predict_and_replay-sequential": ("predict_and_replay", ((4, 5),),
                                      {**WRAPPER_NOISE, "batched": False}),
}


def _same_result(a, b):
    """Every field of two ``SimResult``s equal, float64 to the bit."""
    assert type(a).__name__ == type(b).__name__ == "SimResult"
    for f in ("batch_time", "throughput_iters", "throughput_tokens",
              "bubble_fraction"):
        x, y = getattr(a, f), getattr(b, f)
        assert np.float64(x).tobytes() == np.float64(y).tobytes(), f
    assert list(a.utilization) == list(b.utilization)
    assert np.array_equal(np.array(list(a.utilization.values())),
                          np.array(list(b.utilization.values())))
    assert a.timeline.n_devices == b.timeline.n_devices
    assert [(x.device, x.kind, x.start, x.end)
            for x in a.timeline.activities] == [
        (x.device, x.kind, x.start, x.end) for x in b.timeline.activities]


def _same_batch(a, b):
    """Every array of two ``TimelineBatch``es equal, float64 to the bit."""
    assert type(a).__name__ == type(b).__name__ == "TimelineBatch"
    assert a.seeds == b.seeds
    for f in ("n_devices", "dp", "pp", "mp", "n_sim"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("batch_times", "busy", "offsets"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.float64 and x.tobytes() == \
            y.tobytes(), f
    for f in ("starts", "ends"):
        assert len(getattr(a, f)) == len(getattr(b, f))
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_deprecated_wrapper_bit_identical(case):
    """Each of ``DistSim``'s five deprecated wrappers warns (the
    reference's message, a ``DeprecationWarning``) and returns the
    reference wrapper's result on the same config, strategy and
    provider: every field of its ``SimResult`` or ``TimelineBatch``
    equal, float64 to the bit — the seeds and ``predict_and_replay``'s
    sequential ``engine.run(seed=)`` path included."""
    name, args, kw = WRAPPERS[case]
    out, said = [], []
    for sim in sims("gpt2_345m", False, SCHEDULES["interleaved"],
                    "A40_CLUSTER"):
        call = dict(kw)
        if call.get("positions") == "own":
            call["positions"] = sim.positions()
        with pytest.warns(DeprecationWarning,
                          match=rf"^DistSim\.{name}\(\) is deprecated; "
                                r"use DistSim\.") as rec:
            out.append(getattr(sim, name)(*args, **call))
        assert len(rec) == 1 and rec[0].filename == __file__
        said.append(str(rec[0].message))
    assert said[0] == said[1]
    a, b = out
    if name.endswith("_batched"):
        _same_batch(a, b)
    elif name == "predict_and_replay":
        _same_result(a[0], b[0])
        assert len(a[1]) == len(b[1]) == len(args[0] if args else (0,))
        for x, y in zip(a[1], b[1]):
            _same_result(x, y)
    else:
        _same_result(a, b)
