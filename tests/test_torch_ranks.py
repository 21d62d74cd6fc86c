"""Rank workers of the port's multi-rank tests, and the reference's
n-device runs they are held against. No tests of its own.

``run(jobs, world, tmp)`` starts, all at once, ``world`` processes of
the port — each a rank of a gloo process group that meets through a
``FileStore`` under ``tmp`` (no TCP port), one thread each — and one
child ``python`` that runs the reference on ``world`` CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``, which never
reaches the test process), under ``jax.set_mesh`` / ``jax.shard_map``
with DeprecationWarnings ignored (``jax.lax.pvary`` warns under jax 0.9,
and ``pyproject.toml`` makes that an error in the suite). Each process
runs this file as a script and saves a dict of numpy arrays; ``run``
returns the reference's dict and the ranks' dicts. Every input is made
here from a seed, the same in every process.

Jobs (each keyed ``<job>/...`` in the outputs):

* ``ring``: ring attention over a ``("cp",)`` mesh, every case of
  :data:`RING_CASES`, sequence sharded evenly;
* ``ep``: the expert-parallel MoE over each (data, model) mesh of
  :func:`ep_meshes`, y and aux, and on (1, 2) the gradients of
  ``sum(y²) + 0.01·aux``;
* ``psum``: ``compressed_psum`` over a ``("data",)`` mesh, each rank's
  gradients from :func:`psum_inputs`;
* ``placements``: each spec of :data:`PLACEMENT_SPECS` on a (2, 2) mesh:
  the port's local shard against the slice JAX's ``NamedSharding``
  gives the device at the same mesh position;
* ``attention``: the model's attention on DTensors with heads sharded
  over a 2-rank ``model`` axis, against the plain call (port only).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"

# --------------------------------------------------------------------------
# seeded inputs
# --------------------------------------------------------------------------

#: name → (dtype, causal, window, n_rep); B=2, S=64, 4 query heads, hd 16,
#: blocks of 8. The window (8) is shorter than a shard on 2 and 4 ranks,
#: so whole shards fall outside it.
RING_CASES = {
    "fp32_causal_gqa": ("float32", True, None, 2),
    "fp32_window_gqa": ("float32", True, 8, 2),
    "fp32_bidirectional": ("float32", False, None, 1),
    "bf16_causal_gqa": ("bfloat16", True, None, 2),
    "bf16_window": ("bfloat16", True, 8, 1),
}
RING_SHAPE = dict(b=2, s=64, h=4, hd=16, block=8)


def ring_inputs(name):
    """q, k, v (fp32 numpy; cast to the case's dtype by each side) and
    positions (B, S) for a ring case."""
    _, _, _, n_rep = RING_CASES[name]
    b, s, h, hd = (RING_SHAPE[k] for k in ("b", "s", "h", "hd"))
    rng = np.random.default_rng(sorted(RING_CASES).index(name))
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, h // n_rep, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, h // n_rep, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return q, k, v, pos


#: the MoE of the ``ep`` job: B=2, S=64, d 16, 8 experts of d_ff 32,
#: top 2, capacity factor 1.0 (drops on every mesh)
MOE = dict(b=2, s=64, d=16, e=8, f=32, top_k=2, cf=1.0)


def moe_inputs():
    """x (B, S, d) and the MoE's weights, fp32 numpy."""
    rng = np.random.default_rng(7)
    d, e, f = MOE["d"], MOE["e"], MOE["f"]
    arrays = {
        "router": rng.standard_normal((d, e), dtype=np.float32) * 0.1,
        "w_gate": rng.standard_normal((e, d, f), dtype=np.float32) * 0.1,
        "w_up": rng.standard_normal((e, d, f), dtype=np.float32) * 0.1,
        "w_down": rng.standard_normal((e, f, d), dtype=np.float32) * 0.1,
    }
    x = rng.standard_normal((MOE["b"], MOE["s"], d), dtype=np.float32)
    return x, arrays


def moe_kwargs():
    return dict(n_experts=MOE["e"], top_k=MOE["top_k"],
                d_ff_expert=MOE["f"], capacity_factor=MOE["cf"])


def ep_meshes(world):
    """The (data, model) meshes the ``ep`` job runs on for ``world``."""
    return {1: [(1, 1)], 2: [(1, 2)], 4: [(1, 4), (2, 2)]}[world]


#: the mesh whose gradients the ``ep`` job also computes
EP_GRAD_MESH = (1, 2)


def psum_inputs(rank):
    """Rank ``rank``'s gradient tree: fp32 leaves and a bf16 one (kept
    as fp32 numpy, cast by each side), a different draw per rank."""
    rng = np.random.default_rng(100 + rank)
    return {"b": rng.standard_normal((8,), dtype=np.float32) * 1e-3,
            "w": rng.standard_normal((16, 8), dtype=np.float32),
            "w_bf16": rng.standard_normal((4, 32), dtype=np.float32)}


#: name → (shape, spec entries) on a (2, 2) ("data", "model") mesh
PLACEMENT_SPECS = {
    "1d_data": ((8,), ("data",)),
    "1d_both": ((8,), (("data", "model"),)),
    "2d_rows": ((8, 12), ("data", None)),
    "2d_cols": ((8, 12), (None, "model")),
    "2d_both": ((8, 12), ("data", "model")),
    "2d_swapped": ((8, 12), ("model", "data")),
    "2d_tuple_rows": ((8, 12), (("data", "model"), None)),
    "2d_tuple_cols": ((8, 12), (None, ("data", "model"))),
}


def placement_input(name):
    shape, _ = PLACEMENT_SPECS[name]
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


# --------------------------------------------------------------------------
# the port's side: one process a rank
# --------------------------------------------------------------------------

def _torch_dtype(name):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def port_ring(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as sh
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("cp",))
    s_loc = RING_SHAPE["s"] // world
    own = slice(rank * s_loc, (rank + 1) * s_loc)
    out = {}
    for name, (dtype, causal, window, _) in RING_CASES.items():
        q, k, v, pos = ring_inputs(name)
        dt = _torch_dtype(dtype)
        q, k, v = (torch.from_numpy(a[:, own]).to(dt) for a in (q, k, v))
        pos = torch.from_numpy(pos[:, own])
        with sh.use_mesh(mesh), torch.no_grad():
            o = L.ring_attention(q, k, v, pos, pos, "cp", causal, window,
                                 RING_SHAPE["block"], RING_SHAPE["block"])
        out[f"ring/{name}"] = o.float().numpy()
    return out


def _moe_port(mesh, x, arrays, grad):
    """y, aux (and this rank's gradients) of the port's ep_a2a with x and
    the weights placed as the layout contract asks."""
    import torch

    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    from repro_torch.models.layers import ModelOptions
    from repro_torch.parallel import sharding as sh
    opts = ModelOptions(moe_impl="ep_a2a", ep_axis="model",
                        dp_axes=("data",))
    leaves = {k: torch.from_numpy(v).requires_grad_(grad)
              for k, v in arrays.items()}
    xt = torch.from_numpy(x).requires_grad_(grad)
    specs = {"router": sh.P(), "w_gate": sh.P("model", None, None),
             "w_up": sh.P("model", None, None),
             "w_down": sh.P("model", None, None)}
    with sh.use_mesh(mesh), torch.set_grad_enabled(grad):
        params = {k: sh.distribute(leaves[k], specs[k], mesh) for k in specs}
        xd = sh.distribute(xt, sh.P(("data",), "model", None), mesh)
        y, aux = M.moe_ffn(xd, params, MoEConfig(**moe_kwargs()), "ep_a2a",
                           opts)
        out = {"y": y.full_tensor().detach().numpy(),
               "aux": aux.full_tensor().detach().numpy()}
        if grad:
            # the ranks' losses add up to the reference's: sum(y²) over
            # all tokens, plus the replicated aux term once
            loss = (y.to_local() ** 2).sum() \
                + 0.01 * aux.to_local() / mesh.size()
            loss.backward()
            out.update({f"grad/{k}": v.grad.numpy()
                        for k, v in leaves.items()})
            out["grad/x"] = xt.grad.numpy()
    return out


def port_ep(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    x, arrays = moe_inputs()
    out = {}
    for dp, ep in ep_meshes(world):
        mesh = init_device_mesh("cpu", (dp, ep),
                                mesh_dim_names=("data", "model"))
        got = _moe_port(mesh, x, arrays, (dp, ep) == EP_GRAD_MESH)
        out.update({f"ep/{dp}x{ep}/{k}": v for k, v in got.items()})
    return out


def port_psum(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import sharding as sh
    from repro_torch.train.compression import compressed_psum
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    grads = {k: torch.from_numpy(v) for k, v in psum_inputs(rank).items()}
    grads["w_bf16"] = grads["w_bf16"].to(torch.bfloat16)
    with sh.use_mesh(mesh):
        got = compressed_psum(grads, "data")
    return {f"psum/{k}": v.float().numpy() for k, v in got.items()}


def port_placements(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import sharding as sh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for name, (_, entries) in PLACEMENT_SPECS.items():
        x = torch.from_numpy(placement_input(name))
        out[f"placements/{name}"] = sh.distribute(
            x, sh.P(*entries), mesh).to_local().numpy()
    return out


def port_attention(rank, world):
    """The model's attention with q/k/v placed heads-over-``model`` on a
    (1, world) mesh, against the plain call on the whole tensors."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as sh
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    q, k, v, pos = ring_inputs("fp32_causal_gqa")
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.from_numpy(pos)
    heads = sh.P(None, None, "model", None)
    out = {}
    for impl in ("naive", "flash_torch"):
        opts = L.ModelOptions(dtype=torch.float32, attn_impl=impl,
                              block_q=8, block_kv=8)
        want = L.attention(q, k, v, pos, pos, window=8, opts=opts)
        got = L.attention(*(sh.distribute(t, heads, mesh) for t in (q, k, v)),
                          pos, pos, window=8, opts=opts)
        out[f"attention/{impl}/placements"] = np.array(
            [p.is_shard(2) for p in got.placements])
        out[f"attention/{impl}/local_heads"] = np.array(
            got.to_local().shape[2])
        out[f"attention/{impl}/got"] = got.full_tensor().numpy()
        out[f"attention/{impl}/want"] = want.numpy()
    return out


PORT_JOBS = {"ring": port_ring, "ep": port_ep, "psum": port_psum,
             "placements": port_placements, "attention": port_attention}


def rank_main(jobs, rank, world, store, out_path):
    import warnings
    warnings.filterwarnings("error", category=DeprecationWarning,
                            module="repro")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for job in jobs:
            out.update(PORT_JOBS[job](rank, world))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)


# --------------------------------------------------------------------------
# the reference's side: one child on n CPU devices
# --------------------------------------------------------------------------

def _jnp_dtype(name):
    import jax.numpy as jnp
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def reference_ring(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.models import layers as R
    mesh = jax.make_mesh((n,), ("cp",))
    out = {}
    for name, (dtype, causal, window, _) in RING_CASES.items():
        q, k, v, pos = ring_inputs(name)
        q, k, v = (jnp.asarray(a).astype(_jnp_dtype(dtype))
                   for a in (q, k, v))
        blk = RING_SHAPE["block"]
        f = jax.shard_map(
            lambda q, k, v, p, c=causal, w=window: R.ring_attention(
                q, k, v, p, p, "cp", c, w, blk, blk),
            mesh=mesh, in_specs=(JP(None, "cp"),) * 4,
            out_specs=JP(None, "cp"))
        with jax.set_mesh(mesh):
            o = jax.jit(f)(q, k, v, jnp.asarray(pos))
        out[f"ring/{name}"] = np.asarray(o.astype(jnp.float32))
    return out


def reference_moe(mesh_shape, x, arrays, grad):
    """y, aux (and the gradients) of the reference's ep_a2a on a (data,
    model) mesh of ``mesh_shape``."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import MoEConfig
    from repro.models.layers import ModelOptions
    from repro.models.moe import moe_ffn
    mesh = jax.make_mesh(mesh_shape, ("data", "model"))
    opts = ModelOptions(moe_impl="ep_a2a", ep_axis="model",
                        dp_axes=("data",))
    mcfg = MoEConfig(**moe_kwargs())
    xj = jnp.asarray(x)
    pj = {k: jnp.asarray(v) for k, v in arrays.items()}

    def loss(p, xx):
        y, aux = moe_ffn(xx, p, mcfg, "ep_a2a", opts)
        return (y ** 2).sum() + 0.01 * aux

    with jax.set_mesh(mesh):
        y, aux = jax.jit(lambda xx, p: moe_ffn(xx, p, mcfg, "ep_a2a",
                                               opts))(xj, pj)
        out = {"y": np.asarray(y), "aux": np.asarray(aux)}
        if grad:
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(pj, xj)
            out.update({f"grad/{k}": np.asarray(v) for k, v in gp.items()})
            out["grad/x"] = np.asarray(gx)
    return out


def reference_ep(n):
    x, arrays = moe_inputs()
    out = {}
    for dp, ep in ep_meshes(n):
        got = reference_moe((dp, ep), x, arrays, (dp, ep) == EP_GRAD_MESH)
        out.update({f"ep/{dp}x{ep}/{k}": v for k, v in got.items()})
    return out


def reference_psum(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.train.compression import compressed_psum
    mesh = jax.make_mesh((n,), ("data",))
    per_rank = [psum_inputs(r) for r in range(n)]
    stacked = {k: jnp.stack([jnp.asarray(g[k]) for g in per_rank])
               for k in per_rank[0]}
    stacked["w_bf16"] = stacked["w_bf16"].astype(jnp.bfloat16)
    f = jax.shard_map(lambda g: compressed_psum(
        {k: v[0] for k, v in g.items()}, "data"), mesh=mesh,
        in_specs=(JP("data"),), out_specs=JP())
    # eager, the reference's operations as written: under jit XLA turns
    # quantize_int8's division by 127 into a product by 1/127, which moves
    # some scales by one ulp
    with jax.set_mesh(mesh):
        got = f(stacked)
    return {f"psum/{k}": np.asarray(v.astype(jnp.float32))
            for k, v in got.items()}


def reference_placements(n):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, (shape, entries) in PLACEMENT_SPECS.items():
        x = placement_input(name)
        index = NamedSharding(mesh, JP(*entries)).devices_indices_map(shape)
        out[f"placements/{name}"] = np.stack(
            [x[index[mesh.devices[i, j]]] for i in range(2)
             for j in range(2)])
    return out


REFERENCE_JOBS = {"ring": reference_ring, "ep": reference_ep,
                  "psum": reference_psum,
                  "placements": reference_placements}


def reference_main(jobs, n, out_path):
    import warnings
    warnings.simplefilter("ignore", DeprecationWarning)
    out = {}
    for job in jobs:
        if job in REFERENCE_JOBS:
            out.update(REFERENCE_JOBS[job](n))
    np.savez(out_path, **out)


# --------------------------------------------------------------------------
# running them
# --------------------------------------------------------------------------

def child_env(**extra):
    """This process's environment with ``src`` on the path, one thread,
    gloo on the loopback device, and ``extra``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo", **extra)
    return env


def run(jobs, world, tmp, timeout=300):
    """(reference outputs, [rank outputs]) of ``jobs`` on ``world`` ranks
    and ``world`` reference devices; the processes run concurrently."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    jobs = ",".join(jobs)
    me = str(pathlib.Path(__file__).resolve())
    outs = [tmp / f"rank{r}.npz" for r in range(world)]
    cmds = [([sys.executable, me, "rank", jobs, str(r), str(world),
              str(tmp / "store"), str(outs[r])], child_env())
            for r in range(world)]
    ref_out = tmp / "reference.npz"
    cmds.append(([sys.executable, me, "reference", jobs, str(world),
                  str(ref_out)],
                 child_env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
                     f"--xla_force_host_platform_device_count={world}"))))
    procs = [subprocess.Popen(c, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in cmds]
    failed = []
    try:
        for (cmd, _), p in zip(cmds, procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                failed.append(f"{' '.join(cmd[2:4])}: rc {p.returncode}\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))

    def load(path):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}

    return load(ref_out), [load(o) for o in outs]


if __name__ == "__main__":
    role, jobs = sys.argv[1], sys.argv[2].split(",")
    if role == "rank":
        rank_main(jobs, int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                  sys.argv[6])
    else:
        reference_main(jobs, int(sys.argv[3]), sys.argv[4])
