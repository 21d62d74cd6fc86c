"""The port's dry run against the reference's: the per-device FLOPs of
each smoke family's train and prefill cell (and the MoE's and the
enc-dec's decode cell, with their collective bytes), the CLI on 256
fake ranks, and the production meshes on the CPU.

The reference lowers its cells in a child python on 4 forced CPU devices
(``tests/test_torch_dryrun_ref.py``): its ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when imported, which this process must never see. The
port traces the same cells here, over a fake process group of 4 ranks,
on the (2, 2) mesh: the SSM families' block split over ``model`` by
heads, as XLA splits it.

Bars. Where both sides do the same work the port's count is held within
10 % of the reference's ``hlo_stats``. The one gap of that kind is the
SSM's depthwise convolution, which the port counts and the HLO analyser
(dots only) does not, well inside the bar. Where the work differs
it is held to its exact cause. The flash cells (seq 4096: ``auto``'s
2048-key threshold passed) are where it differs: the port's
``flash_torch`` skips the block pairs the causal mask empties, the
reference's ``flash_jnp`` scans every pair. So the port is traced twice,
once as it runs and once with no pair skipped: the second is held within
10 % of the reference, and the first is the second less the FLOPs of the
skipped pairs, exactly, counted from the pairs each attention call was
given.
"""
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import test_torch_dryrun_ref as ref
import test_torch_ranks as ranks
from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
from repro_torch.core import roofline as PR
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import _mesh, make_production_mesh
from repro_torch.models import layers as L

CLOSE = 0.10          # the bar where both sides compute the same work
#: block products of one live pair: QKᵀ and PV forward; the recompute
#: of QKᵀ, then dV, dP, dQ and dK backward
PAIR_PRODUCTS = {"_flash_fwd_impl": 2, "_flash_bwd_impl": 5}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``hlo_stats`` of every cell, by cell name."""
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(ref.__file__)), str(out)],
        capture_output=True, text=True, timeout=900,
        env=ranks.child_env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _port_stats(arch, kind, seq, batch):
    cfg = smoke_config(get_config(arch))
    shape = ShapeConfig(f"{kind}_{seq}", seq, batch, kind)
    with D.fake_world(4):
        mesh = _mesh("cpu", ref.MESH, ("data", "model"))
        opts = D.model_options(cfg, shape, mesh)
        fsdp, model_axis = D.fsdp_axes(cfg, shape, mesh, False, "tp_sp")
        stats, *_ = D.trace_step(cfg, shape, opts, mesh, fsdp, model_axis,
                                 device="cpu")
    return stats


def _port_flops(arch, kind, seq, batch):
    return _port_stats(arch, kind, seq, batch)["flops"]


def _skipped_pairs_flops(monkeypatch):
    """A list that gathers, while the test runs, the FLOPs of the block
    pairs each blockwise attention call skips."""
    skipped = []
    for name, products in PAIR_PRODUCTS.items():
        def spy(q, *args, _impl=getattr(L, name), _products=products):
            *_, block_q, block_kv, pairs = args
            b, h, _, hd = q.shape
            n = sum(row.count(L.SKIP) for row in pairs)
            skipped.append(n * _products * 2 * b * h * block_q * block_kv
                           * hd)
            return _impl(q, *args)
        monkeypatch.setattr(L, name, spy)
    return skipped


def _no_pair_skipped(monkeypatch):
    """Every block pair computed, as the reference's ``flash_jnp`` does:
    a pair the masks empty is computed masked instead of skipped."""
    pairs_of = L._block_pairs

    def every_pair(*args):
        return [[L.PARTIAL if kind == L.SKIP else kind for kind in row]
                for row in pairs_of(*args)]
    monkeypatch.setattr(L, "_block_pairs", every_pair)


CELL_IDS = [ref.cell_name(a, k, s) for f, a in ref.FAMILIES.items()
            for k, s, _ in ref.cells_of(f)]


DECODE_IDS = [ref.cell_name(ref.FAMILIES[f], k, s)
              for f, cells in ref.DECODE_CELLS.items() for k, s, _ in cells]


@pytest.mark.parametrize("cell", DECODE_IDS)
def test_decode_collective_bytes_within_the_references(reference, cell):
    """The MoE's and the enc-dec's decode move no more collective bytes a
    device than the reference's XLA, within the bar: the MoE's combine
    reduces a pending sum of the tokens' rows, it gathers no expert's
    rows."""
    arch, rest = cell.split("/")
    kind, seq = rest.split("_")
    want = reference[cell]["total"]
    got = _port_stats(arch, kind, int(seq), 8)["total"]
    assert 0 < got <= (1 + CLOSE) * want, (got, want)


@pytest.mark.parametrize("cell", CELL_IDS)
def test_per_device_flops_against_the_references(reference, cell,
                                                  monkeypatch):
    arch, rest = cell.split("/")
    kind, seq = rest.split("_")
    seq = int(seq)
    want = reference[cell]["flops"]
    skipped = _skipped_pairs_flops(monkeypatch)
    got = _port_flops(arch, kind, seq, 8)
    cfg = get_config(arch)
    if not (cfg.n_heads and (seq // 2 if cfg.enc_dec else seq) > 2048):
        assert not skipped
        assert abs(got - want) <= CLOSE * want, (got, want)
        return
    assert sum(skipped) > 0
    _no_pair_skipped(monkeypatch)
    every = _port_flops(arch, kind, seq, 8)
    assert abs(every - want) <= CLOSE * want, (every, want)
    assert got == every - sum(skipped), (got, every, sum(skipped))


def test_the_cli_traces_a_smoke_cell_on_256_fake_ranks(tmp_path):
    out = tmp_path / "dryrun.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2_1_5b", "--shape", "train_4k", "--multi-pod", "single",
         "--smoke", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=ranks.child_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "[ok] qwen2_1_5b/train_4k/16x16" in proc.stdout
    header, row = out.read_text().splitlines()
    assert header == PR.HEADER
    fields = row.split(",")
    assert fields[:4] == ["qwen2_1_5b", "train_4k", "16x16", "256"]
    assert all(float(fields[i]) > 0 for i in (7, 8, 9))


@pytest.mark.parametrize("flags", [("--mapping", "fsdp_cp"), ("--baseline",)],
                         ids=["fsdp_cp", "baseline"])
def test_the_cli_traces_the_other_mappings(flags):
    """The reference's other mappings of a train cell: ``fsdp_cp`` (no
    tensor parallelism, the sequence over ``model``, ZeRO-3 over both
    axes) and ``--baseline`` (no beyond-paper options), each lowering."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2_1_5b", "--shape", "train_4k", "--multi-pod", "single",
         "--smoke", "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=600, env=ranks.child_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "[ok] qwen2_1_5b/train_4k/16x16" in proc.stdout


def test_the_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would trace for it")
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        D.main(["--arch", "qwen2_1_5b", "--smoke"])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_on_the_cpu(multi_pod):
    n = 512 if multi_pod else 256
    with D.fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.device_type == "cpu"
        assert tuple(mesh.mesh.shape) == ((2, 16, 16) if multi_pod
                                          else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))


@pytest.mark.parametrize("mapping,rank", [("fsdp_cp", 15), ("tp_sp", 0)])
def test_the_dry_run_traces_the_rank_that_bounds_the_step(mapping, rank):
    """A train cell under ``--mapping fsdp_cp`` is traced on the last
    ``model`` coordinate, rank 15 of 16 x 16, whose queries see every
    key before them; every other mapping on rank 0."""
    from repro_torch.configs.base import SHAPES
    assert D.traced_rank(SHAPES["train_4k"], mapping) == rank
    assert D.traced_rank(SHAPES["prefill_32k"], mapping) == 0
    with D.fake_world(256, rank):
        mesh = make_production_mesh(device="cpu")
        assert tuple(mesh.get_coordinate()) == (0, rank)


def test_fsdp_cp_counts_more_work_on_the_last_model_rank(monkeypatch):
    """The smoke qwen2 train cell on 16 x 16 under ``--mapping fsdp_cp``
    (the sequence split over ``model``, causal attention in blocks): the
    last ``model`` rank, which the dry run traces, runs more FLOPs than
    rank 0 (``flash_torch`` skips fewer of its block pairs), and both
    ranks' no-skip counts — as run plus the skipped pairs — are equal."""
    counts = {}
    for rank in (0, 15):
        skipped = _skipped_pairs_flops(monkeypatch)
        monkeypatch.setattr(D, "traced_rank", lambda *a, _r=rank: _r)
        rep, _ = D.lower_cell("qwen2_1_5b", "train_4k", False,
                              mapping="fsdp_cp", device="cpu", smoke=True,
                              layers=1)
        counts[rank] = (rep.hlo_flops, sum(skipped))
    assert counts[15][0] > counts[0][0] and counts[0][1] > counts[15][1]
    assert sum(counts[15]) == sum(counts[0])
    monkeypatch.undo()
    rep, _ = D.lower_cell("qwen2_1_5b", "train_4k", False,
                          mapping="fsdp_cp", device="cpu", smoke=True,
                          layers=1)
    assert rep.hlo_flops == counts[15][0]


def test_a_production_mesh_needs_its_process_group():
    with D.fake_world(4), pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device="cpu")


def test_model_options_are_the_references_rules():
    """On the 16 x 16 mesh: Megatron-SP for training, KV heads replicated
    where they do not divide ``model``, expert parallelism where the
    experts do, and the flash blocks halved to the VMEM budget."""
    class Mesh:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    from repro_torch.configs.base import SHAPES
    h2o = D.model_options(get_config("h2o_danube_1_8b"), SHAPES["train_4k"],
                          Mesh())
    assert tuple(h2o.act_spec) == ("data", "model", None)
    assert tuple(h2o.kv_spec)[2] is None and tuple(h2o.qkv_spec)[2] == "model"
    assert h2o.remat and (h2o.block_q, h2o.block_kv) == (512, 1024)
    # 16 sequences of 6 heads a device: the score tile halved to fit
    big = D.model_options(get_config("mistral_large_123b"),
                          SHAPES["train_4k"], Mesh())
    assert (big.block_q, big.block_kv) == (256, 1024)
    moe = D.model_options(get_config("qwen3_moe_30b_a3b"),
                          SHAPES["prefill_32k"], Mesh())
    assert moe.moe_impl == "ep_a2a" and moe.ep_axis == "model"
    assert not moe.remat
    base = D.model_options(get_config("h2o_danube_1_8b"), SHAPES["train_4k"],
                           Mesh(), baseline=True)
    assert base.act_spec is None and (base.block_q, base.block_kv) == (512,
                                                                       1024)
