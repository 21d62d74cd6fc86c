"""The manifest, the files it names, and the shape of a run's result."""
import dataclasses
import importlib
import json
import re

import pytest
import torch

from bench import harness, weights

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
#: cells kept as data only, for a later PR to add: Open questions row 1
AS_DATA = {"workloads": [{"name": "h2o_danube_1_8b.prefill_8k",
                          "config": "h2o_danube_1_8b",
                          "traffic": "prefill_8k", "chips": 1}],
           "end_to_end": MANIFEST["end_to_end"],
           "per_layer": MANIFEST["per_layer"]}


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_units_and_text_use_the_allowed_characters():
    entries = (MANIFEST["configs"] + MANIFEST["workloads"]
               + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and key != "source" or key == "source" and "file" in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_entries_have_only_the_contract_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for part, want in keys.items():
        for e in MANIFEST[part]:
            assert set(e) - {"workloads"} == want, e


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_its_files_by_name(cell):
    c = harness.resolve(MANIFEST, cell)
    assert c.limits, "a cell needs its limits file"
    conf = next(e for e in MANIFEST["configs"] if e["name"] == c.config_name)
    assert conf["file"] == f"bench/configs/{c.config_name}.json"
    assert conf["reduced"] == c.config["reduced"]
    assert conf["source"] == c.config["source"]
    kind = harness.kind_module(c)
    assert callable(kind.run)
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported


def test_a_cell_given_only_as_data_resolves():
    """Open questions row 1 (h2o_danube_1_8b.prefill_8k): its config and
    traffic files are in ``bench/``; a later PR adds the entry and its
    limits file, and no code."""
    c = harness.resolve(AS_DATA, "h2o_danube_1_8b.prefill_8k")
    assert c.kind == "prefill" and c.limits == {}
    assert harness.kind_module(c).run
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert harness.model_options(c.config, "prefill").attn_impl == "cuda"


def test_every_config_and_traffic_file_is_used_or_kept_as_data():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert {p.stem for p in (harness.BENCH / "configs").glob("*.json")} \
        == used
    mixes = {w["traffic"] for w in MANIFEST["workloads"] + AS_DATA[
        "workloads"]}
    assert {p.stem for p in (harness.BENCH / "traffic").glob("*.json")} \
        == mixes
    for mix in mixes:
        kind = harness.read_json(harness.BENCH / "traffic" / f"{mix}.json")[
            "kind"]
        assert importlib.import_module(f"bench.kinds.{kind}")


def test_every_per_layer_metric_has_its_reader_and_names_its_cells():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert harness.metric_path(m["name"]).exists()
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["unit"] == "%":
            assert m["name"].endswith(("_roofline.train",
                                       "_roofline.prefill")) or \
                "mfu" in m["name"]


def test_one_reader_serves_a_metric_of_each_kind():
    assert harness.metric_path("mfu.train") == harness.metric_path(
        "mfu.prefill") == harness.BENCH / "metrics" / "mfu.py"
    assert harness.metric_path("adamw_ms.train").name == "adamw_ms.train.py"


@pytest.mark.parametrize("where,name", [
    ("configs", p.stem) for p in sorted((harness.BENCH / "configs").glob(
        "*.json"))] + [("tests/fixtures/configs", "tiny_moe")])
def test_weights_are_the_ports_parameter_layout(where, name):
    from repro_torch.models import lm
    cfg = harness.read_json(harness.BENCH / where / f"{name}.json")
    arch = harness.port_config(cfg)
    from repro_torch.models.api import specs_of
    port = specs_of(lm.init_params(arch, torch.Generator(), "meta",
                                   harness.model_options(cfg, "prefill")))
    ours = dict(weights.paths(weights.shapes(cfg)))
    theirs = {p: tuple(s.shape) for p, s in weights.paths(port)}
    assert ours == theirs
    if where == "configs":
        # the file's numbers are the registered config's, the dry run's,
        # except where it states a head width, q/k norms or a capacity
        from repro_torch.configs.base import get_config
        registered = get_config(name)
        for key, value in harness.port_fields(cfg).items():
            if key in harness.OPTIONAL_KEYS:
                assert getattr(arch, key) == cfg[key], key
            elif key == "moe" and value is not None:
                assert arch.moe.capacity_factor == cfg["moe"][
                    "capacity_factor"]
                assert dataclasses.replace(
                    arch.moe, capacity_factor=registered.moe.capacity_factor
                ) == registered.moe
            else:
                assert getattr(arch, key) == getattr(registered, key), key


def test_a_cycle_of_lengths_gives_one_batch_a_length_from_the_seed():
    from bench import traffic
    from bench.kinds import prefill
    mix = {"kind": "prefill", "batch": 1, "lengths": [5, 9, 3, 7],
           "warmup": 4, "checked_requests": 2, "sample_within": 4}
    cfg = {"vocab": 100}
    a, b = traffic.pool(mix, cfg, 2 ** 31 + 5, "cpu"), traffic.pool(
        mix, cfg, 2 ** 31 + 5, "cpu")
    assert [traffic.shape(x) for x in a] == [(1, 5), (1, 9), (1, 3), (1, 7)]
    assert all(torch.equal(x["tokens"], y["tokens"]) for x, y in zip(a, b))
    for seed in range(6):
        chosen = prefill.sample(mix, seed)
        assert 1 in chosen and len(chosen) == 2     # the 9-token prompt


def test_weights_are_drawn_layer_by_layer_from_the_seed():
    cfg = harness.read_json(harness.BENCH / "tests" / "fixtures" / "configs"
                            / "tiny_moe.json")
    a, b = weights.make(cfg, 7, "cpu"), weights.make(cfg, 7, "cpu")
    c = weights.make(cfg, 2 ** 31 + 7, "cpu")
    for (p, x), (_, y), (_, z) in zip(weights.paths(a), weights.paths(b),
                                      weights.paths(c)):
        assert torch.equal(x, y)
        if x.dim() >= 2 and not p.rsplit(".", 1)[-1].startswith("ln"):
            assert not torch.equal(x, z)
            if p.startswith("attn_layers."):
                assert not torch.equal(x[0], x[1])


def test_a_run_without_a_card_fails_and_prints_no_result(capsys,
                                                         monkeypatch):
    from bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


@pytest.mark.parametrize("name", ["tiny_dense.train", "tiny_moe.prefill",
                                  "tiny_dense.prefill_mixed"])
def test_the_result_line_has_the_contract_keys_in_order(tiny, name):
    cell = tiny(name)
    out = harness.kind_module(cell).run(cell, 3, 0.05, False, "cpu", 0.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m for m in ("train_tokens_per_s", "setup_s")} \
        if cell.kind == "train" else {"prefill_tokens_per_s",
                                      "prefill_ms_p90", "setup_s"}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_the_kinds_report_the_manifests_end_to_end_metrics():
    by_kind = {"train": {"train_tokens_per_s", "setup_s"},
               "prefill": {"prefill_tokens_per_s", "prefill_ms_p90",
                           "setup_s"}}
    for cell in CELLS:
        c = harness.resolve(MANIFEST, cell)
        assert {m["name"] for m in c.end_to_end} == by_kind[c.kind]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_card(card, cell):
    c = harness.resolve(MANIFEST, cell)
    out = harness.kind_module(c).run(c, 20260, 5, False, card, 0.0)
    assert out["correct"], out["checks"]
