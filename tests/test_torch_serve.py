"""The slice as a whole: the same ``ServeQuery`` list (train, prefill,
decode; two clusters) through the reference's ``DistSim.serve_batch``
and the port's, each on a store of its own — answers equal field for
field, floats bit for bit (host float64 arithmetic plus the ``+``/
``max`` recurrence; nothing rounds differently). Then the state that
crosses packages: a store warmed by the reference serves the port with
zero provider evaluations, and the reference's build pickles in it are
counted and never opened.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core as ref
import repro.core.scenario as ref_scn
import repro.store as ref_store
import repro_torch.core as port
import repro_torch.core.scenario as port_scn
import repro_torch.store as port_store
from repro_torch.store.profile_store import provider_namespace

QUERY_SPECS = [
    # (arch, strategy kwargs, global_batch, seq, smoke, cluster, scenario)
    ("gpt2_345m", dict(mp=1, pp=2, dp=2, microbatches=4), 16, 128, False,
     "a40-cluster", None),
    ("gpt2_345m", dict(mp=2, pp=2, dp=1, microbatches=8,
                       schedule="gpipe"), 16, 128, False, "a40-cluster",
     None),
    ("bert_large", dict(mp=1, pp=4, dp=1, microbatches=8,
                        schedule="interleaved", vpp=2), 16, 128, False,
     "v5e-pod", None),
    ("qwen3_moe_30b_a3b", dict(mp=2, pp=2, dp=2, microbatches=2), 8, 64,
     True, "v5e-pod", None),
    ("gpt2_345m", dict(mp=2, pp=2, dp=2, microbatches=4), 16, 256, False,
     "a40-cluster", ("Prefill", {})),
    ("gpt2_345m", dict(mp=2, pp=2, dp=2, microbatches=4), 16, 256, False,
     "v5e-pod", ("Decode", dict(steps=4, context=1024))),
    ("bert_large", dict(mp=1, pp=2, dp=2, microbatches=2), 8, 128, False,
     "a40-cluster", ("Decode", dict(steps=3,
                                    arrivals=(0.0, 1e-4, 2e-4)))),
    ("gpt_145b", dict(mp=8, pp=16, dp=1, microbatches=16), 16, 2048,
     False, "a40-cluster", None),
]


def queries(pkg, scn, store_pkg, specs=QUERY_SPECS):
    out = []
    for arch, kw, gb, seq, smoke, cluster, scenario in specs:
        sc = scn.TRAIN if scenario is None else \
            getattr(scn, scenario[0])(**scenario[1])
        out.append(store_pkg.ServeQuery(
            arch, pkg.Strategy(**kw), global_batch=gb, seq=seq,
            smoke=smoke, cluster=cluster, scenario=sc))
    return out


def ref_queries(specs=QUERY_SPECS):
    return queries(ref, ref_scn, ref_store, specs)


def port_queries(specs=QUERY_SPECS):
    return queries(port, port_scn, port_store, specs)


@pytest.fixture(scope="module")
def answered(tmp_path_factory):
    """Both packages answer the list once, each on its own store."""
    root = tmp_path_factory.mktemp("stores")
    want = ref.DistSim.serve_batch(ref_queries(), str(root / "ref"),
                                   backend="numpy")
    server = port.DistSim.serve(str(root / "port"), device="cpu")
    got = server.answer_batch(port_queries())
    return root, want, got, server


@pytest.mark.parametrize("i", range(len(QUERY_SPECS)))
def test_answers_equal_field_for_field(answered, i):
    _, want, got, _ = answered
    w, g = want[i].to_dict(), got[i].to_dict()
    assert g.keys() == w.keys()
    for key in w:
        assert g[key] == w[key], key          # floats: bit for bit
    assert json.dumps(g, sort_keys=True) == json.dumps(w, sort_keys=True)


def test_port_ran_the_plain_scan_on_the_cpu(answered):
    _, _, _, server = answered
    assert server.backend == "auto" and server.device.type == "cpu"
    progs = list(server._programs.values())
    assert len(progs) == 2                          # one per cluster
    assert all(mb.resolve_backend("auto") == "torch" for mb in progs)
    assert all(mb.device_bytes() > 0 for mb in progs)


@pytest.mark.parametrize("i", range(len(QUERY_SPECS)))
def test_answers_match_per_query_simulate(answered, i):
    _, _, got, _ = answered
    q = got[i].query
    cfg = port_store.StrategyServer._resolve_cfg(q)
    sim = port.DistSim(cfg, q.strategy, q.global_batch, q.seq,
                       port.provider_for(port.CLUSTERS[q.cluster]),
                       scenario=q.scenario)
    assert got[i].batch_time == sim.simulate().batch_time


def test_query_round_trips_through_both_packages(answered):
    _, want, got, _ = answered
    for w, g in zip(want, got):
        d = json.loads(json.dumps(w.query.to_dict()))
        assert port_store.ServeQuery.from_dict(d) == g.query
        assert ref_store.ServeQuery.from_dict(
            json.loads(json.dumps(g.query.to_dict()))) == w.query


def test_repeat_batch_reuses_program_and_profiles_nothing(answered):
    _, _, got, server = answered
    before = server.snapshot()
    again = server.answer_batch(port_queries())
    after = server.snapshot()
    assert [a.to_dict() for a in again] == [a.to_dict() for a in got]
    assert after["programs_reused"] == before["programs_reused"] + 2
    for name, c in after["clusters"].items():
        assert c["evaluations"] == before["clusters"][name]["evaluations"]


def test_store_warmed_by_reference_serves_port_cold_free(tmp_path):
    """Event shards interchange; build pickles do not."""
    store = str(tmp_path / "shared")
    want = ref.DistSim.serve_batch(ref_queries(), store, backend="numpy")
    server = port.DistSim.serve(store, device="cpu")
    got = server.answer_batch(port_queries())
    assert [g.to_dict() for g in got] == [w.to_dict() for w in want]
    snap = server.snapshot()
    assert set(snap["clusters"]) == {"a40-cluster", "v5e-pod"}
    for c in snap["clusters"].values():
        assert c["evaluations"] == 0              # zero re-profiling
        assert c["unique_events"] > 0
    st = snap["store"]
    assert st["events_loaded"] > 0
    assert st["builds_loaded"] == 0               # none of ITS builds yet
    assert st["foreign_rejected"] > 0             # the reference's: seen,
    assert st["corrupt_rejected"] == 0            # counted, never opened
    assert st["builds_saved"] > 0
    # the port's builds went to a directory of their own; the
    # reference's are untouched and still serve the reference
    ns = provider_namespace(port.AnalyticalProvider(port.A40_CLUSTER))
    assert os.listdir(os.path.join(store, ns, "builds"))
    assert os.listdir(os.path.join(store, ns, "builds_torch"))
    again = ref.DistSim.serve(store, backend="numpy")
    assert [a.to_dict() for a in again.answer_batch(ref_queries())] == \
        [w.to_dict() for w in want]
    assert again.snapshot()["store"]["corrupt_rejected"] == 0
    # and a second port server is served its own builds
    third = port.DistSim.serve(store, device="cpu")
    third.answer_batch(port_queries())
    assert third.snapshot()["store"]["builds_loaded"] > 0


def test_misplaced_reference_pickle_is_rejected_as_corrupt(tmp_path):
    """A reference pickle copied to where the port keeps its own: the
    restricted unpickler refuses it (counted, not served, not
    imported) and the query is answered from a fresh build."""
    store = str(tmp_path / "shared")
    specs = QUERY_SPECS[:1]
    want = ref.DistSim.serve_batch(ref_queries(specs), store,
                                   backend="numpy")
    ns = provider_namespace(port.AnalyticalProvider(port.A40_CLUSTER))
    src = os.path.join(store, ns, "builds")
    dst = os.path.join(store, ns, "builds_torch")
    shutil.copytree(src, dst)
    server = port.DistSim.serve(store, device="cpu")
    got = server.answer_batch(port_queries(specs))
    assert got[0].to_dict() == want[0].to_dict()
    st = server.snapshot()["store"]
    assert st["corrupt_rejected"] > 0 and st["builds_loaded"] == 0


_SUBPROCESS = """
import json, sys
import repro_torch.core as port
import repro_torch.core.scenario as scn
from repro_torch.store import ServeQuery
qs = [ServeQuery.from_dict(d) for d in json.loads(sys.argv[2])]
server = port.DistSim.serve(sys.argv[1], device="cpu")
answers = server.answer_batch(qs)
snap = server.snapshot()
assert snap["store"]["foreign_rejected"] > 0, snap
assert all(c["evaluations"] == 0 for c in snap["clusters"].values()), snap
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "repro"
       or m.startswith("repro.")]
assert not bad, bad
print(json.dumps([a.to_dict() for a in answers]))
"""


def test_port_never_imports_reference_over_a_shared_store(tmp_path):
    """In a process of its own: the port answers from a store full of
    the reference's pickles and neither ``repro`` nor ``jax`` is ever
    imported."""
    store = str(tmp_path / "shared")
    want = ref.DistSim.serve_batch(ref_queries(), store, backend="numpy")
    payload = json.dumps([q.to_dict() for q in port_queries()])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS, store,
                           payload], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == [json.loads(json.dumps(w.to_dict())) for w in want]


def test_unknown_cluster_and_perturb_raise(tmp_path):
    server = port.DistSim.serve(str(tmp_path / "s"), device="cpu")
    with pytest.raises(ValueError, match="unknown cluster"):
        server.answer(port_store.ServeQuery(
            "gpt2_345m", port.Strategy(), cluster="nope"))
    with pytest.raises(NotImplementedError, match="perturb"):
        port_store.ServeQuery("gpt2_345m", port.Strategy(),
                              perturb=object())
    with pytest.raises(NotImplementedError, match="perturb"):
        port_store.ServeQuery.from_dict(
            {"arch": "gpt2_345m", "strategy": port.Strategy().to_dict(),
             "perturb": {"stragglers": []}})


def test_serve_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.DistSim.serve(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.DistSim.serve_batch([], str(tmp_path / "s"))
    assert port_store.ServeQuery("gpt2_345m", port.Strategy()).cluster \
        == "h100-cluster"
