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
* ``ring_grad``: the gradients of ``sum(out · ct)`` with respect to q,
  k and v of ring attention, every case of :data:`RING_CASES` (the
  reference's by ``jax.grad``), each rank's shards;
* ``ep``: the expert-parallel MoE over each (data, model) mesh of
  :func:`ep_meshes`, y and aux, and on (1, 2) the gradients of
  ``sum(y²) + 0.01·aux``;
* ``psum``: ``compressed_psum`` over a ``("data",)`` mesh, each rank's
  gradients from :func:`psum_inputs`;
* ``placements``: each spec of :data:`PLACEMENT_SPECS` on a (2, 2) mesh:
  the port's local shard against the slice JAX's ``NamedSharding``
  gives the device at the same mesh position;
* ``attention``: the model's attention on DTensors with heads, then the
  sequence, sharded over a 2-rank ``model`` axis, against the plain call
  (port only; the sequence case with its gradients); also
  with one KV head for four query heads, which stays whole on each rank,
  and its gradients;
* ``decode``: six greedy decode steps of the smoke qwen2_1_5b from an
  empty cache, parameters (FSDP over ``data``) and cache placed by
  ``param_specs`` / ``cache_specs(seq_axis="data")`` on each mesh of
  :data:`DECODE_MESHES`, against the plain steps (port only);
* ``fsdp_step``: the smoke qwen2_1_5b train step on a (2, 2) mesh, the
  parameters placed by ``param_specs(fsdp_axes="data")``, the moments by
  ``zero1_specs``, the batch over ``data``, against the plain step; the
  steps of :data:`FSDP_FAMILIES` likewise; and the qwen2 step under the
  dry run's ``fsdp_cp`` mapping (port only);
* ``tp_step``: the train steps of :data:`TP_STEPS` on a (2, 2) mesh under
  the dry run's own options, one attention head a rank, against the
  plain step (port only);
* ``serve_decode``: greedy decode of :data:`SERVE_DECODE`'s MoE and
  enc-dec configs on a (2, 2) mesh, parameters and cache placed as the
  dry run places them, against the plain steps (port only).
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


def ring_cotangent(name):
    """The seeded fp32 weights ``ct`` of the ring's gradient loss
    ``sum(out · ct)``, shaped like the output."""
    b, s, h, hd = (RING_SHAPE[k] for k in ("b", "s", "h", "hd"))
    rng = np.random.default_rng(50 + sorted(RING_CASES).index(name))
    return rng.standard_normal((b, s, h, hd), dtype=np.float32)


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


def ring_grad_local(mesh, axis, own, name):
    """This rank's gradients of ``sum(out · ct)`` by ring attention over
    ``axis`` of ``mesh``, q, k and v its sequence shard ``own``."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as sh
    dtype, causal, window, _ = RING_CASES[name]
    q, k, v, pos = ring_inputs(name)
    dt = _torch_dtype(dtype)
    q, k, v = (torch.from_numpy(a[:, own]).to(dt).requires_grad_()
               for a in (q, k, v))
    pos = torch.from_numpy(pos[:, own])
    ct = torch.from_numpy(ring_cotangent(name)[:, own])
    with sh.use_mesh(mesh):
        o = L.ring_attention(q, k, v, pos, pos, axis, causal, window,
                             RING_SHAPE["block"], RING_SHAPE["block"])
    (o.float() * ct).sum().backward()
    return {f"{g}": t.grad.float().numpy() for g, t in
            zip("qkv", (q, k, v))}


def port_ring_grad(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("cp",))
    s_loc = RING_SHAPE["s"] // world
    own = slice(rank * s_loc, (rank + 1) * s_loc)
    return {f"ring_grad/{name}/{g}": a for name in RING_CASES
            for g, a in ring_grad_local(mesh, "cp", own, name).items()}


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
        # the sequence over ``model`` (context parallelism): each rank's
        # queries against the whole K/V, gradients summed over the ranks
        leaves = [torch.from_numpy(a.numpy()).requires_grad_()
                  for a in (q, k, v)]
        seq = sh.P(None, "model", None, None)
        got = L.attention(*(sh.distribute(t, seq, mesh) for t in leaves),
                          sh.distribute(pos, sh.P(None, "model"), mesh),
                          pos, window=8, opts=opts)
        ct = torch.from_numpy(ring_cotangent("fp32_causal_gqa"))
        (got.to_local() * ct.chunk(world, 1)[rank]).sum().backward()
        plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        (L.attention(*plain, pos, pos, window=8, opts=opts) * ct).sum() \
            .backward()
        out[f"attention/{impl}/seq/got"] = got.full_tensor().detach().numpy()
        for g, t, w in zip("qkv", leaves, plain):
            out[f"attention/{impl}/seq/grad_{g}"] = t.grad.numpy()
            out[f"attention/{impl}/seq/want_{g}"] = w.grad.numpy()
    return out


def port_attention_replicated_kv(rank, world):
    """Four query heads over the 2-rank ``model`` axis and one KV head
    (placed whole on both ranks): output and q, k, v gradients of
    ``sum(out · ct)`` against the plain call's."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as sh
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    q, k, v, pos = ring_inputs("fp32_causal_gqa")
    k, v = k[:, :, :1], v[:, :, :1]
    ct = torch.from_numpy(ring_cotangent("fp32_causal_gqa"))
    pos = torch.from_numpy(pos)
    out = {}
    for impl in ("naive", "flash_torch"):
        opts = L.ModelOptions(dtype=torch.float32, attn_impl=impl,
                              block_q=8, block_kv=8)
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        want = L.attention(*leaves, pos, pos, window=8, opts=opts)
        (want * ct).sum().backward()
        wants = [t.grad.numpy() for t in leaves]
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        placed = [sh.distribute(leaves[0], sh.P(None, None, "model", None),
                                mesh)] + [sh.distribute(t, sh.P(), mesh)
                                          for t in leaves[1:]]
        got = L.attention(*placed, pos, pos, window=8, opts=opts)
        (got.to_local() * ct.chunk(world, 2)[rank]).sum().backward()
        key = f"attention_rkv/{impl}"
        out[f"{key}/got"] = got.full_tensor().detach().numpy()
        out[f"{key}/want"] = want.detach().numpy()
        for g, t, w in zip("qkv", leaves, wants):
            out[f"{key}/grad_{g}"] = t.grad.numpy()
            out[f"{key}/want_{g}"] = w
    return out


#: (data, model) mesh, batch and dtype of the ``decode`` job: the
#: cache's sequence over ``model`` (in fp32 and bf16); batch over
#: ``data`` and KV heads over ``model``; the sequence over ``data``
#: beside the heads over ``model``
DECODE_MESHES = {"seq_model": ((1, 4), 2, "float32"),
                 "seq_model_bf16": ((1, 4), 2, "bfloat16"),
                 "batch_heads": ((2, 2), 2, "float32"),
                 "seq_data_heads": ((2, 2), 1, "float32")}
DECODE_STEPS, DECODE_SEQ = 6, 32


def port_decode(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import ModelOptions
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.step import make_serve_step
    cfg = smoke_config(get_config("qwen2_1_5b"))
    out = {}
    for name, (shape, b, dtype) in DECODE_MESHES.items():
        opts = ModelOptions(dtype=_torch_dtype(dtype))
        api = build_model(cfg, opts)
        params = api.init(torch.Generator().manual_seed(0), "cpu")
        step = make_serve_step(cfg, opts)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        bax = ("data",)
        cache = api.init_cache(b, DECODE_SEQ, "cpu")
        dcache = sh.distribute_tree(cache, sh.cache_specs(
            cache, mesh, bax, seq_axis="data"), mesh)
        dparams = sh.distribute_tree(params, sh.param_specs(
            params, mesh, fsdp_axes="data"), mesh)
        tok = torch.arange(b, dtype=torch.int32)[:, None] + 3
        dtok = tok
        got, want = [], []
        for _ in range(DECODE_STEPS):
            logits, cache = step(params, cache, {"tokens": tok})
            with sh.use_mesh(mesh):
                dlogits, dcache = step(dparams, dcache, {"tokens": dtok})
            want.append(logits.float().numpy())
            got.append(dlogits.full_tensor().float().numpy())
            tok = dtok = logits.argmax(-1).to(torch.int32)[:, None]
        out[f"decode/{name}/got"] = np.stack(got)
        out[f"decode/{name}/want"] = np.stack(want)
        out[f"decode/{name}/seq_sharded"] = np.array(any(
            p.is_shard(2) for p in dcache["attn"]["k"].placements))
    return out


def port_fsdp_step(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import ModelOptions
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    cfg = smoke_config(get_config("qwen2_1_5b"))
    out = {}
    for impl in ("naive", "flash_torch"):
        opts = ModelOptions(dtype=torch.float32, attn_impl=impl,
                            block_q=16, block_kv=16, remat=True)
        params = build_model(cfg, opts).init(
            torch.Generator().manual_seed(0), "cpu")
        state = opt.init(params)
        toks = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        _, _, want = make_train_step(cfg, opts)(params, state, batch)
        pspecs = sh.param_specs(params, mesh, fsdp_axes="data")
        ospecs = sh.zero1_specs(state, opt.state_specs(pspecs), mesh)
        step = make_train_step(cfg, opts, grad_specs=pspecs)
        with sh.use_mesh(mesh):
            got_p, _, got = step(
                sh.distribute_tree(params, pspecs, mesh),
                sh.distribute_tree(state, ospecs, mesh),
                sh.distribute_tree(batch, sh.batch_specs(
                    batch, mesh, ("data",)), mesh))
        out[f"fsdp_step/{impl}/embed_placements"] = np.array(
            [str(p) for p in got_p["embed"].placements])
        for k in ("loss", "grad_norm"):
            out[f"fsdp_step/{impl}/{k}"] = got[k].numpy()
            out[f"fsdp_step/{impl}/want_{k}"] = want[k].numpy()
    for arch in FSDP_FAMILIES:
        out.update(_fsdp_family_step(mesh, arch))
    out.update(_fsdp_cp_step(mesh))
    return out


def _fsdp_cp_step(mesh):
    """The smoke qwen2 step under the dry run's ``fsdp_cp`` mapping: no
    tensor parallelism, the sequence over ``model`` (context
    parallelism), ZeRO-3 over both axes; against the plain step."""
    import torch

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import ModelOptions
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    cfg = smoke_config(get_config("qwen2_1_5b"))
    plain = ModelOptions(dtype=torch.float32, attn_impl="flash_torch",
                         block_q=16, block_kv=16, remat=True)
    cp = ModelOptions(**{**plain.__dict__,
                         "act_spec": sh.P("data", "model", None),
                         "qkv_spec": sh.P("data", "model", None, None),
                         "kv_spec": sh.P("data", "model", None, None)})
    params = build_model(cfg, plain).init(torch.Generator().manual_seed(0),
                                          "cpu")
    state = opt.init(params)
    toks = torch.randint(0, cfg.vocab, (2, 40), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    _, _, want = make_train_step(cfg, plain)(params, state, batch)
    pspecs = sh.param_specs(params, mesh, model_axis="__no_tp__",
                            fsdp_axes=("data", "model"))
    step = make_train_step(cfg, cp, grad_specs=pspecs)
    with sh.use_mesh(mesh):
        _, _, got = step(sh.distribute_tree(params, pspecs, mesh),
                         sh.distribute_tree(state, opt.state_specs(pspecs),
                                            mesh),
                         sh.distribute_tree(batch, sh.batch_specs(
                             batch, mesh, ("data",)), mesh))
    return {f"fsdp_step/fsdp_cp/{w}{k}": m[k].numpy()
            for w, m in (("", got), ("want_", want))
            for k in ("loss", "grad_norm")}


#: the other families' smoke steps of the ``fsdp_step`` job (naive
#: attention): the SSM block split over ``model`` by heads (alone, and
#: in the hybrid beside attention and the gather MoE), the enc-dec and
#: the VLM
FSDP_FAMILIES = ("mamba2_2_7b", "jamba_v0_1_52b", "whisper_tiny",
                 "qwen2_vl_72b")


def _fsdp_family_step(mesh, arch):
    import torch

    from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.models.layers import ModelOptions
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    cfg = smoke_config(get_config(arch))
    opts = ModelOptions(dtype=torch.float32, attn_impl="naive", remat=True)
    params = build_model(cfg, opts).init(torch.Generator().manual_seed(0),
                                         "cpu")
    state = opt.init(params)
    batch = make_batch(cfg, ShapeConfig("fsdp", 64, 2, "train"),
                       torch.Generator().manual_seed(1), "cpu", opts)
    _, _, want = make_train_step(cfg, opts)(params, state, batch)
    pspecs = sh.param_specs(params, mesh, fsdp_axes="data")
    ospecs = sh.zero1_specs(state, opt.state_specs(pspecs), mesh)
    step = make_train_step(cfg, opts, grad_specs=pspecs)
    with sh.use_mesh(mesh):
        _, _, got = step(sh.distribute_tree(params, pspecs, mesh),
                         sh.distribute_tree(state, ospecs, mesh),
                         sh.distribute_tree(batch, sh.batch_specs(
                             batch, mesh, ("data",)), mesh))
    return {f"fsdp_step/{arch}/{w}{k}": m[k].numpy()
            for w, m in (("", got), ("want_", want))
            for k in ("loss", "grad_norm")}


#: the ``tp_step`` job's configs: the smoke config of each widened so
#: that ``model`` (2 ranks) holds one attention head a rank (t5's
#: full-width cell on 16 x 16 holds one of 16), under the dry run's
#: Megatron-SP options at seq 64, batch 4
TP_STEPS = {"t5_large": dict(d_model=128, n_heads=2, n_kv_heads=2)}


def port_tp_step(rank, world):
    """The train step of each :data:`TP_STEPS` config on a (2, 2) mesh
    under the dry run's ``model_options`` (the residual stream's
    sequence over ``model``, attention heads over ``model``, FSDP over
    ``data``, ZeRO-1), in fp32, against the plain step (port only)."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
    from repro_torch.launch.dryrun import model_options
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    shape = ShapeConfig("tp_step", 64, 4, "train")
    out = {}
    for arch, widths in TP_STEPS.items():
        cfg = dataclasses.replace(smoke_config(get_config(arch)), **widths)
        opts = dataclasses.replace(model_options(cfg, shape, mesh),
                                   dtype=torch.float32)
        plain = dataclasses.replace(opts, act_spec=None, qkv_spec=None,
                                    kv_spec=None)
        params = build_model(cfg, opts).init(
            torch.Generator().manual_seed(0), "cpu")
        state = opt.init(params)
        batch = make_batch(cfg, shape, torch.Generator().manual_seed(1),
                           "cpu", opts)
        _, _, want = make_train_step(cfg, plain)(params, state, batch)
        pspecs = sh.param_specs(params, mesh, fsdp_axes="data")
        ospecs = sh.zero1_specs(state, opt.state_specs(pspecs), mesh)
        step = make_train_step(cfg, opts, grad_specs=pspecs)
        with sh.use_mesh(mesh):
            _, _, got = step(sh.distribute_tree(params, pspecs, mesh),
                             sh.distribute_tree(state, ospecs, mesh),
                             sh.distribute_tree(batch, sh.batch_specs(
                                 batch, mesh, ("data",)), mesh))
        out.update({f"tp_step/{arch}/{w}{k}": m[k].numpy()
                    for w, m in (("", got), ("want_", want))
                    for k in ("loss", "grad_norm")})
    return out


#: the ``uneven`` job's configs and the (data, model) mesh of each:
#: smoke configs whose vocabulary (257) and heads (3) do not divide
#: ``model``, the dense model (GQA over one KV head, q/k/v biases, tied
#: head) on (2, 2) — two head slots a rank, the second rank's last one
#: padding — and the enc-dec one (its cross-attention too) on (1, 4),
#: one slot a rank, the last rank's padding only
UNEVEN = {"qwen2_1_5b": (dict(d_model=48, n_heads=3, n_kv_heads=1,
                              vocab=257), (2, 2)),
          "whisper_tiny": (dict(d_model=48, n_heads=3, n_kv_heads=3,
                                vocab=257), (1, 4))}


def port_uneven(rank, world):
    """The train step and the prefill of each :data:`UNEVEN` config on
    its mesh under the dry run's ``model_options`` (heads over
    ``model``, padded to a multiple of its size; the vocabulary whole,
    the cross-entropy on each rank's rows), in fp32, beside the plain
    step and forward (port), with the parameters and the batch, for the
    reference's loss and logits on the same inputs."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
    from repro_torch.launch.dryrun import model_options
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_prefill_step, make_train_step
    from repro_torch.train.tree import leaf_paths
    out = {}
    for arch, (widths, dims) in UNEVEN.items():
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(smoke_config(get_config(arch)), **widths)
        for kind in ("train", "prefill"):
            shape = ShapeConfig(f"uneven_{kind}", 64, 4, kind)
            opts = dataclasses.replace(model_options(cfg, shape, mesh),
                                       dtype=torch.float32)
            plain = dataclasses.replace(opts, act_spec=None, qkv_spec=None,
                                        kv_spec=None)
            params = build_model(cfg, opts).init(
                torch.Generator().manual_seed(0), "cpu")
            batch = make_batch(cfg, shape, torch.Generator().manual_seed(1),
                               "cpu", opts)
            pspecs = sh.param_specs(params, mesh, fsdp_axes="data")
            dbatch = sh.distribute_tree(batch, sh.batch_specs(
                batch, mesh, ("data",)), mesh)
            key = f"uneven/{arch}/{kind}"
            if rank == 0:
                out.update({f"{key}/param/{p}": v.numpy()
                            for p, v in leaf_paths(params)})
                out.update({f"{key}/batch/{k}": v.numpy()
                            for k, v in batch.items()})
            if kind == "prefill":
                want = make_prefill_step(cfg, plain)(params, batch)
                with sh.use_mesh(mesh):
                    got = make_prefill_step(cfg, opts)(
                        sh.distribute_tree(params, pspecs, mesh), dbatch)
                out[f"{key}/logits"] = got.full_tensor().numpy()
                out[f"{key}/want_logits"] = want.numpy()
                continue
            state = opt.init(params)
            _, _, want = make_train_step(cfg, plain)(params, state, batch)
            ospecs = sh.zero1_specs(state, opt.state_specs(pspecs), mesh)
            step = make_train_step(cfg, opts, grad_specs=pspecs)
            with sh.use_mesh(mesh):
                _, _, got = step(sh.distribute_tree(params, pspecs, mesh),
                                 sh.distribute_tree(state, ospecs, mesh),
                                 dbatch)
            out.update({f"{key}/{w}{k}": m[k].numpy()
                        for w, m in (("", got), ("want_", want))
                        for k in ("loss", "grad_norm")})
    return out


#: the ``serve_decode`` job's configs (smoke, with their overrides): the
#: MoE model, whose FFN takes ``moe_impl="gather"`` in decode (its
#: combine on DTensors); the enc-dec audio model with 3 heads, which
#: do not divide ``model`` (2 ranks): the cross-attention's q is
#: gathered and its K/V cache split over the sequence; and the SSM
#: model and the hybrid, whose SSM step runs where ``cache_specs``
#: places the cache (mamba2's conv channels and state heads split over
#: ``model`` in chunks that ``in_proj``'s columns do not match, the
#: hybrid's state split over ``model`` by its batch)
SERVE_DECODE = {"qwen3_moe_30b_a3b": {},
                "whisper_tiny": dict(d_model=48, n_heads=3, n_kv_heads=3),
                "mamba2_2_7b": {}, "jamba_v0_1_52b": {}}
SERVE_BATCH, SERVE_SEQ, SERVE_FRAMES = 4, 16, 16


def port_serve_decode(rank, world):
    """Greedy decode steps of each :data:`SERVE_DECODE` config with its
    parameters (FSDP over ``data``) and its cache placed on a (2, 2)
    mesh as the dry run places them (``cache_specs(seq_axis="data")``),
    against the plain steps, in fp32 (port only)."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig, get_config, smoke_config
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.models.layers import ModelOptions
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.step import make_serve_step
    from repro_torch.train.tree import map_leaves
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    bax = ("data",)
    out = {}
    for arch, widths in SERVE_DECODE.items():
        cfg = dataclasses.replace(smoke_config(get_config(arch)), **widths)
        opts = ModelOptions(dtype=torch.float32)
        params = build_model(cfg, opts).init(
            torch.Generator().manual_seed(0), "cpu")
        shape = ShapeConfig("serve", SERVE_SEQ, SERVE_BATCH, "decode")
        batch = make_batch(cfg, shape, torch.Generator().manual_seed(1),
                           "cpu", opts)
        cache, tok = batch["cache"], batch["batch"]["tokens"]
        cache["pos"].zero_()
        dcache = sh.distribute_tree(map_leaves(torch.clone, cache),
                                    sh.cache_specs(cache, mesh, bax,
                                                   seq_axis="data"), mesh)
        dparams = sh.distribute_tree(params, sh.param_specs(
            params, mesh, fsdp_axes="data"), mesh)
        step = make_serve_step(cfg, opts)
        got, want = [], []
        dtok = tok
        for _ in range(DECODE_STEPS):
            logits, cache = step(params, cache, {"tokens": tok})
            with sh.use_mesh(mesh):
                dlogits, dcache = step(dparams, dcache, {"tokens": dtok})
            want.append(logits.float().numpy())
            got.append(dlogits.full_tensor().float().numpy())
            tok = dtok = logits.argmax(-1).to(torch.int32)[:, None]
        out[f"serve_decode/{arch}/got"] = np.stack(got)
        out[f"serve_decode/{arch}/want"] = np.stack(want)
    return out


PORT_JOBS = {"ring": port_ring, "ring_grad": port_ring_grad, "ep": port_ep,
             "psum": port_psum, "placements": port_placements, "attention": port_attention,
             "attention_rkv": port_attention_replicated_kv,
             "decode": port_decode,
             "fsdp_step": port_fsdp_step, "tp_step": port_tp_step,
             "uneven": port_uneven, "serve_decode": port_serve_decode}


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


def reference_ring_grad_case(n, name):
    """``jax.grad`` of ``sum(out · ct)`` with respect to q, k, v of the
    reference's ring under ``shard_map`` on ``n`` devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.models import layers as R
    dtype, causal, window, _ = RING_CASES[name]
    q, k, v, pos = ring_inputs(name)
    q, k, v = (jnp.asarray(a).astype(_jnp_dtype(dtype)) for a in (q, k, v))
    ct = jnp.asarray(ring_cotangent(name))
    blk = RING_SHAPE["block"]
    mesh = jax.make_mesh((n,), ("cp",))
    f = jax.shard_map(
        lambda q, k, v, p: R.ring_attention(q, k, v, p, p, "cp", causal,
                                            window, blk, blk),
        mesh=mesh, in_specs=(JP(None, "cp"),) * 4, out_specs=JP(None, "cp"))

    def loss(q, k, v):
        return (f(q, k, v, jnp.asarray(pos)).astype(jnp.float32) * ct).sum()

    with jax.set_mesh(mesh):
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return {g: np.asarray(t.astype(jnp.float32))
            for g, t in zip("qkv", grads)}


def reference_ring_grad(n):
    return {f"ring_grad/{name}/{g}": a for name in RING_CASES
            for g, a in reference_ring_grad_case(n, name).items()}


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


def reference_attention(n):
    """The reference's attention with q, k, v and the query positions
    placed sequence-over-``model`` on a (1, n) mesh, XLA partitioning
    it, and ``jax.grad`` of ``sum(out · ct)``: what the port's
    context-parallel attention (``port_attention``'s ``seq`` half) is
    held to. Naive and blockwise (``flash_jnp``, the port's
    ``flash_torch``), blocks of 8, window 8."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.models import layers as R
    mesh = jax.make_mesh((1, n), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    q, k, v, pos = ring_inputs("fp32_causal_gqa")
    ct = jnp.asarray(ring_cotangent("fp32_causal_gqa"))
    seq = NamedSharding(mesh, JP(None, "model", None, None))
    args = [jax.device_put(jnp.asarray(a), seq) for a in (q, k, v)]
    args += [jax.device_put(jnp.asarray(pos),
                            NamedSharding(mesh, JP(None, "model"))),
             jnp.asarray(pos)]
    out = {}
    for impl, ref_impl in (("naive", "naive"), ("flash_torch", "flash_jnp")):
        opts = R.ModelOptions(dtype=jnp.float32, attn_impl=ref_impl,
                              block_q=8, block_kv=8)

        def f(q, k, v, q_pos, k_pos, opts=opts):
            return R.attention(q, k, v, q_pos, k_pos, window=8, opts=opts)

        def loss(*a, f=f):
            return (f(*a) * ct).sum()

        with jax.set_mesh(mesh):
            o = jax.jit(f)(*args)
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
        key = f"attention/{impl}/seq"
        out[f"{key}/ref"] = np.asarray(o)
        for g, t in zip("qkv", grads):
            out[f"{key}/ref_{g}"] = np.asarray(t)
    return out


REFERENCE_JOBS = {"ring": reference_ring, "ring_grad": reference_ring_grad,
                  "attention": reference_attention, "ep": reference_ep,
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
