"""The port's gradient compression (``repro_torch.train.compression``)
against the reference's ``repro.train.compression``: int8 quantization
and its inverse bit for bit on seeded inputs, error feedback over ten
steps, and ``compressed_psum`` on 1 rank (in this process) and on 2 and
4 ranks (spawned, ``tests/test_torch_ranks.py``) against the reference's
``shard_map`` over as many CPU devices — bit for bit: an int32 sum, a
max and one fp32 product and division. The reference runs eagerly, its
operations as written (under ``jax.jit`` XLA replaces the division by
127 with a product by its reciprocal, one ulp off on some scales).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh

import test_torch_ranks as ranks
from repro.train import compression as R
from repro_torch.parallel import sharding as sh
from repro_torch.train import compression as C


def _bits(t):
    """A tensor's bit pattern as numpy, bf16 included."""
    t = t.reshape(-1)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.uint8)


def _jbits(a):
    a = np.asarray(a).reshape(-1)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.uint8)


CASES = {
    "normal": lambda rng: rng.standard_normal((64, 33), dtype=np.float32),
    "tiny": lambda rng: rng.standard_normal((17,), dtype=np.float32) * 1e-6,
    "wide": lambda rng: rng.standard_normal((8, 8), dtype=np.float32)
    * np.float32(1e4),
    "halves": lambda rng: (np.arange(-254, 255, dtype=np.float32) / 2.0),
    "zeros": lambda rng: np.zeros((5, 3), dtype=np.float32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_and_dequantize_are_the_references_bits(case, dtype):
    x = CASES[case](np.random.default_rng(0))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, scale = C.quantize_int8(tx)
    rq, rscale = R.quantize_int8(jx)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert _bits(scale).tobytes() == _jbits(rscale).tobytes()
    np.testing.assert_array_equal(
        _bits(C.dequantize_int8(q, scale)),
        _jbits(R.dequantize_int8(rq, rscale)))


def test_compress_tree_keeps_the_tree():
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((4, 4), dtype=np.float32),
             "b": {"c": rng.standard_normal((3,), dtype=np.float32)}}
    got = C.compress_tree({"a": torch.from_numpy(grads["a"]),
                           "b": {"c": torch.from_numpy(grads["b"]["c"])}})
    want = R.compress_tree(jax.tree.map(jnp.asarray, grads))
    for g, w in ((got["a"], want["a"]), (got["b"]["c"], want["b"]["c"])):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))


def test_error_feedback_over_ten_steps_is_the_references():
    rng = np.random.default_rng(2)
    shapes = {"w": (32, 16), "b": (16,)}
    tres = C.ErrorFeedback.init({k: torch.zeros(s) for k, s in
                                 shapes.items()})
    jres = R.ErrorFeedback.init({k: jnp.zeros(s) for k, s in
                                 shapes.items()})
    for _ in range(10):
        g = {k: rng.standard_normal(s, dtype=np.float32)
             for k, s in shapes.items()}
        tsent, tres = C.ErrorFeedback.apply(
            {k: torch.from_numpy(v) for k, v in g.items()}, tres)
        jsent, jres = R.ErrorFeedback.apply(
            {k: jnp.asarray(v) for k, v in g.items()}, jres)
        for k in shapes:
            np.testing.assert_array_equal(_bits(tsent[k]), _jbits(jsent[k]))
            np.testing.assert_array_equal(_bits(tres[k]), _jbits(jres[k]))
    assert max(float(np.abs(np.asarray(v)).max()) for v in jres.values()) > 0


def _port_grads(rank):
    g = {k: torch.from_numpy(v) for k, v in ranks.psum_inputs(rank).items()}
    g["w_bf16"] = g["w_bf16"].to(torch.bfloat16)
    return g


def test_compressed_psum_on_one_rank_is_the_references(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        grads = _port_grads(0)
        with sh.use_mesh(mesh):
            got = C.compressed_psum(grads, "data")
    finally:
        dist.destroy_process_group()
    g = ranks.psum_inputs(0)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jg["w_bf16"] = jg["w_bf16"].astype(jnp.bfloat16)
    jmesh = jax.make_mesh((1,), ("data",))
    f = jax.shard_map(lambda t: R.compressed_psum(t, "data"), mesh=jmesh,
                      in_specs=(JP(),), out_specs=JP())
    with jax.set_mesh(jmesh):           # eager: see test_torch_ranks
        want = f(jg)
    for k in g:
        assert got[k].dtype == grads[k].dtype
        np.testing.assert_array_equal(_bits(got[k]), _jbits(want[k]))
        # one rank: the sum is the code and the max the scale
        q, scale = C.quantize_int8(grads[k])
        np.testing.assert_array_equal(
            _bits(got[k]), _bits(C.dequantize_int8(q, scale).to(
                grads[k].dtype)))


@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("psum")
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(ranks.run, ["psum"], n, base / f"w{n}")
                   for n in (2, 4)}
        return {n: f.result() for n, f in futures.items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("leaf", ["b", "w", "w_bf16"])
def test_compressed_psum_on_n_ranks_is_the_references(psum_runs, n, leaf):
    ref, outs = psum_runs[n]
    for out in outs:                    # every rank gets the same mean
        np.testing.assert_array_equal(out[f"psum/{leaf}"],
                                      ref[f"psum/{leaf}"])


def test_wire_bytes_are_int32_codes_and_a_scale_a_leaf():
    grads = _port_grads(0)
    n = sum(g.numel() for g in grads.values())
    assert C.wire_bytes(grads) == 4 * n + 4 * len(grads)
