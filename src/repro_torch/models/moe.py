"""Mixture-of-Experts FFN in PyTorch: the port of the reference
package's ``repro.models.moe``, static shapes, capacity-factor routing.

Three implementations, as there:

* ``gather`` (default): per-expert top-capacity token selection by a
  sort over tokens; tokens over capacity are dropped and pass through
  the residual.
* ``dense_dispatch``: Mesh-TF style one-hot dispatch, the same math,
  the small-scale reference of the tests (memory O(T·E·C)).
* ``ep_a2a``: expert parallelism over a mesh axis with two explicit
  all-to-alls a layer (:func:`moe_ep_a2a`); capacity is per rank.

Where the two frameworks differ, the port keeps the reference's result:

* ``jnp.argsort`` is stable and ``torch.argsort`` is not by default, so
  the per-expert queues sort with ``stable=True``: equal gate weights at
  the capacity boundary keep the lower token index, as in the reference.
* ``lax.top_k`` breaks ties towards the lower expert index;
  :func:`router_probs` takes the top k of a stable descending sort,
  which does the same.
* The reference combines the experts' rows with ``.at[].add`` in the
  output dtype. ``index_add_`` on a CUDA tensor adds with atomics, in an
  order (and, in bf16, with roundings) that change from run to run. The
  port instead gathers each token's at most ``top_k`` rows and adds them
  one after the other in ascending expert order, in the output dtype:
  one rounding an add, the same bits on every run and on both devices.

Capacity routing stays non-causal along the sequence, as the reference
documents it (:func:`dropless_capacity_factor`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.parallel.sharding import is_dtensor, settle
from repro_torch.parallel.sharding import place as place_on


def moe_params_shape(d_model: int, mcfg: MoEConfig, mlp_gelu: bool = False):
    e, f = mcfg.n_experts, mcfg.d_ff_expert
    return {
        "router": (d_model, e),
        "w_gate": (e, d_model, f),
        "w_up": (e, d_model, f),
        "w_down": (e, f, d_model),
    }


def capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    c = int(n_tokens * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts)
    c = max(8, (c + 7) // 8 * 8)                     # pad to 8 for layout
    return min(n_tokens, c)


def dropless_capacity_factor(mcfg: MoEConfig) -> float:
    """A capacity factor at which ``capacity(t, mcfg) == t`` for every
    t — no token can ever be dropped. Nominally n_experts / top_k; a
    tiny relative cushion keeps ``int(t * top_k * cf / n_experts)``
    from truncating below t when n_experts isn't divisible by top_k.

    Capacity-factor routing is NON-CAUSAL along the sequence: the
    per-expert sort competes ALL tokens (including future positions)
    for cap slots, so whether token t survives depends on tokens after
    it. Batched (teacher-forced) forward therefore cannot be reproduced
    by token-by-token decode whenever any expert oversubscribes. With a
    dropless capacity the competition never binds and the two paths
    agree.
    """
    return mcfg.n_experts / mcfg.top_k * (1.0 + 1e-6)


def router_probs(x2d: torch.Tensor, router_w: torch.Tensor,
                 mcfg: MoEConfig):
    """x2d: (T, d) → (T, E) softmax probs (fp32), top-k indices/weights
    (ties towards the lower expert index, as ``lax.top_k``)."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topi = torch.argsort(probs, dim=-1, descending=True,
                         stable=True)[:, :mcfg.top_k]          # (T,k)
    topw = torch.gather(probs, 1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topi, topw


def _routing(x2d, router_w, mcfg: MoEConfig, cap: int):
    """The routing both implementations share: probs, top-k, the
    (T, E) gate table ``sel`` (-inf where an expert was not chosen) and
    each expert's queue ``order`` (tokens by descending gate, stable)."""
    t, e = x2d.shape[0], mcfg.n_experts
    probs, topi, topw = router_probs(x2d, router_w, mcfg)
    sel = torch.full((t, e), -torch.inf, dtype=torch.float32,
                     device=x2d.device).scatter(1, topi, topw)
    # routing is a discrete decision: no gradient through the sort
    order = torch.argsort(-sel.detach(), dim=0, stable=True)      # (T,E)
    return probs, topi, sel, order


def _swiglu_experts(xe, w_gate, w_up, w_down):
    """(E, C, d) → (E, C, d): each expert's SwiGLU on its slots, in
    xe's dtype (the weights promoted to it, as ``jnp.einsum`` does)."""
    g = torch.bmm(xe, w_gate.to(xe.dtype))
    u = torch.bmm(xe, w_up.to(xe.dtype))
    return torch.bmm(F.silu(g) * u, w_down.to(xe.dtype))


def _experts(xe, params):
    """:func:`_swiglu_experts` of ``params``. On DTensors each rank
    multiplies its experts' rows (the weights' expert shards) on every
    capacity slot, through ``local_map``, as the reference's XLA places
    the product (its per-device FLOPs on 2 x 2, 4 x 2 and 8 x 2 meshes):
    left to DTensor's strategy choice, torch 2.13 splits the contracted
    width over ``data`` on a 16 x 16 mesh and torch 2.11 does not."""
    ws = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if not (is_dtensor(xe) and all(map(is_dtensor, ws))):
        return _swiglu_experts(xe, *ws)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xe.device_mesh
    place = [Shard(0) if w.is_shard(0) else Replicate()
             for w in ws[0].placements]
    # the rows each rank holds: a weight's gradient is whole on each
    # rank that multiplied all the slots of its experts
    fn = local_map(_swiglu_experts, out_placements=place,
                   in_placements=(place,) * 4,
                   in_grad_placements=(place,) * 4, device_mesh=mesh)
    return fn(place_on(xe, mesh, place),
              *(place_on(w, mesh, place) for w in ws))


def moe_gather(x: torch.Tensor, params, mcfg: MoEConfig):
    """x: (B,S,d) → (B,S,d), probs. Static-shape gather MoE; the
    combine adds each token's rows in ascending expert order. A DTensor
    ``x`` whose sequence is split, with experts that no mesh dimension
    splits, goes through :func:`_gather_on_slots`."""
    if _on_slots(x, params["w_gate"]):
        return _gather_on_slots(x, params, mcfg)
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    cap = capacity(t, mcfg)
    probs, topi, sel, order = _routing(x2d, params["router"], mcfg, cap)

    chosen = order[:cap].T                                  # (E,C) token ids
    # (E,C,d) gather; the gates (E,C)
    xe, gatew = dispatch(x2d, sel, chosen, params["w_gate"])
    live = torch.isfinite(gatew)
    gatew = torch.where(live, gatew, 0.0)

    y = _experts(xe, params)
    y = y * gatew[..., None].to(y.dtype)
    return combine(y, order, topi).reshape(b, s, d), probs


def dispatch(x2d: torch.Tensor, sel: torch.Tensor, chosen: torch.Tensor,
             w_gate: torch.Tensor):
    """The experts' slots (E, C, d) and their gates (E, C): token
    ``chosen[e, c]``'s row of ``x2d`` and its gate ``sel[chosen[e, c],
    e]`` at slot (e, c). On DTensors see :func:`_dispatch_on_shards`."""
    e, cap = chosen.shape
    if is_dtensor(x2d) and is_dtensor(w_gate):
        return _dispatch_on_shards(x2d, sel, chosen, w_gate)
    return (x2d[chosen.reshape(-1)].reshape(e, cap, x2d.shape[-1]),
            torch.gather(sel, 0, chosen.T).T)


def _dispatch_on_shards(x2d, sel, chosen, w_gate):
    """:func:`dispatch` over DTensors, through ``local_map``, as the
    reference's XLA gathers the tokens into the experts' slots: each rank
    fills the slots of its own experts (the experts' weights' shard on
    their mesh dimension) with the rows and gates of its own tokens
    (x2d's shard of its rows; ``sel``'s of its rows and its experts'
    columns) and zeros for the others, a pending sum over the tokens'
    mesh dimensions that is then reduced (an all-reduce of the rank's
    E/ep experts' slots, not a gather of every token on every rank).
    Its backward adds each slot's gradient into its token's row and
    gate on the rank that holds them: the rows' a pending sum over the
    experts' mesh dimension, the gates' split by experts. Left to
    DTensor, the gather all-gathers every token, the gates' backward
    runs the router's on every token on every rank, and the rows'
    backward, a scatter, meets placements it cannot fold (jamba's train
    step under ``--baseline``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x2d.device_mesh
    experts = [i for i, p in enumerate(w_gate.placements) if p.is_shard(0)]
    tok = [Shard(0) if i not in experts and p.is_shard(0) else Replicate()
           for i, p in enumerate(x2d.placements)]
    rows = [i for i, p in enumerate(tok) if p.is_shard(0)]
    ids = [Shard(0) if i in experts else Replicate()
           for i in range(mesh.ndim)]
    gates = [Shard(1) if i in experts else p for i, p in enumerate(tok)]
    out = [Partial() if i in rows else q for i, q in enumerate(ids)]
    x_grad = [Partial() if i in experts else p for i, p in enumerate(tok)]

    def body(x, gates, ids):
        first = 0
        for i in rows:                       # this rank's first token row
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        local = ids.long() - first * x.shape[0]
        mine = (local >= 0) & (local < x.shape[0])
        local = local.clamp(0, x.shape[0] - 1)
        got = x[local.reshape(-1)].reshape(*ids.shape, x.shape[-1])
        cols = torch.arange(ids.shape[0], device=ids.device)[:, None]
        return (torch.where(mine[..., None], got, 0),
                torch.where(mine, gates[local, cols], 0.0))

    fn = local_map(body, out_placements=(out, out),
                   in_placements=(tok, gates, ids),
                   in_grad_placements=(x_grad, gates, ids), device_mesh=mesh)
    xe, gatew = fn(place_on(x2d, mesh, tok), place_on(sel, mesh, gates),
                   place_on(chosen, mesh, ids))
    return settle(xe), settle(gatew)


def _on_slots(x: torch.Tensor, w_gate: torch.Tensor) -> bool:
    """Whether :func:`moe_gather` takes :func:`_gather_on_slots`: ``x`` a
    DTensor whose sequence (dimension 1) a mesh dimension of more than
    one rank splits, as context parallelism places it (``--mapping
    fsdp_cp``), and experts that no mesh dimension splits. Its tokens
    then flatten into no single split of (B·S, d), which DTensor
    cannot place."""
    if not is_dtensor(x):
        return False
    mesh = x.device_mesh
    return (any(p.is_shard(1) and mesh.size(i) > 1
                for i, p in enumerate(x.placements))
            and not (is_dtensor(w_gate)
                     and any(p.is_shard(0) for p in w_gate.placements)))


def _gather_on_slots(x, params, mcfg: MoEConfig):
    """:func:`moe_gather` over a DTensor ``x`` (B, S, d) whose batch and
    sequence are split over mesh dimensions, with the experts whole on
    every rank (ZeRO-3's gathered weights), placed by hand through
    ``local_map`` as the reference's XLA places it under ``--mapping
    fsdp_cp``: each rank routes its own tokens; the gate table (T, E)
    and the tokens are all-gathered, so that every rank forms every
    expert's whole queue (the plain queues, bit for bit); and the
    capacity slots, not the experts, are split over the tokens' mesh
    dimensions, ``C / n`` of every expert's slots a rank (the
    reference's XLA splits the experts' products along d instead, for
    the same FLOPs). Each rank runs every expert on its slots, then adds,
    for every token, the rows of its slots in ascending expert order: a
    pending sum over the ranks, reduce-scattered back to the tokens'
    placement (it runs in another order than the plain combine's where
    a token's rows lie on several ranks). Backward, the tokens' and the
    gates' gradients are reduce-scattered to their owners, and the
    router's and the experts' weights' gradients are pending sums over
    the tokens' mesh dimensions. The capacity is padded to a multiple of
    the ranks with slots that hold no token. Returns y, placed as
    ``x``, and the router's probs (B, S, E), placed as ``x``'s rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    b, s, d = x.shape
    t, e = b * s, mcfg.n_experts
    cap = capacity(t, mcfg)
    tok = [p if p.is_shard() and p.dim < 2 and mesh.size(i) > 1
           else Replicate() for i, p in enumerate(x.placements)]
    split = [i for i, p in enumerate(tok) if p.is_shard()]
    n = math.prod(mesh.size(i) for i in split)
    cs = -(-cap // n)                          # slots of an expert a rank
    rep = [Replicate()] * mesh.ndim
    part = [Partial() if i in split else Replicate()
            for i in range(mesh.ndim)]
    slots = [Shard(1) if i in split else Replicate()
             for i in range(mesh.ndim)]

    def first_slot():
        r = 0
        for i in split:                        # this rank's slots, in order
            r = r * mesh.size(i) + mesh.get_local_rank(i)
        return r * cs

    def route(x, w):
        bl, sl, _ = x.shape
        probs, topi, topw = router_probs(x.reshape(bl * sl, d), w, mcfg)
        sel = torch.full((bl * sl, e), -torch.inf, dtype=torch.float32,
                         device=x.device).scatter(1, topi, topw)
        return probs.reshape(bl, sl, e), sel.reshape(bl, sl, e)

    probs, sel = local_map(
        route, out_placements=(tok, tok), in_placements=(tok, rep),
        in_grad_placements=(tok, part), device_mesh=mesh)(
            place_on(x, mesh, tok), place_on(params["router"], mesh, rep))

    def dispatch_slots(x, sel):
        sel = sel.reshape(t, e)
        # routing is a discrete decision: no gradient through the sort
        order = torch.argsort(-sel.detach(), dim=0, stable=True)   # (T,E)
        c0 = first_slot()
        ids = order[c0:min(c0 + cs, cap)].T                        # (E,c)
        xe = x.reshape(t, d)[ids.reshape(-1)].reshape(e, -1, d)
        gatew = torch.gather(sel, 0, ids.T).T
        if ids.shape[1] < cs:                  # the padding's empty slots
            pad = cs - ids.shape[1]
            xe = F.pad(xe, (0, 0, 0, pad))
            gatew = F.pad(gatew, (0, pad), value=-torch.inf)
        # each token's chosen experts, ascending: its finite gates
        experts = torch.argsort(~torch.isfinite(sel.detach()), dim=1,
                                stable=True)[:, :mcfg.top_k]
        return xe, gatew, _queue_rank(order), experts

    xe, gatew, rank, experts = local_map(
        dispatch_slots, out_placements=(slots, slots, rep, rep),
        in_placements=(rep, rep), in_grad_placements=(part, part),
        device_mesh=mesh)(place_on(x, mesh, rep), place_on(sel, mesh, rep))

    def run_experts(xe, gatew, w_gate, w_up, w_down):
        live = torch.isfinite(gatew)
        gatew = torch.where(live, gatew, 0.0)
        y = _swiglu_experts(xe, w_gate, w_up, w_down)
        return y * gatew[..., None].to(y.dtype)

    ws = [place_on(params[k], mesh, rep) for k in ("w_gate", "w_up",
                                                   "w_down")]
    y = local_map(run_experts, out_placements=slots,
                  in_placements=(slots, slots, rep, rep, rep),
                  in_grad_placements=(slots, slots, part, part, part),
                  device_mesh=mesh)(xe, gatew, *ws)

    def combine_slots(y, rank, experts):
        out = _combine_rows(y, rank, experts, c0=first_slot(), cap=cap)
        return out.reshape(b, s, d)

    out = local_map(combine_slots, out_placements=part,
                    in_placements=(slots, rep, rep),
                    in_grad_placements=(slots, rep, rep),
                    device_mesh=mesh)(y, rank, experts)
    return out.redistribute(mesh, tok), probs


def _queue_rank(order: torch.Tensor) -> torch.Tensor:
    """Each token's rank in each expert's queue, (T, E): the inverse of
    the permutations ``order[:, e]``, as their argsort. It is made from
    ``order`` alone, so it takes its type and placement (a DTensor's
    queues give a DTensor; scattering them into a new plain tensor fails
    there)."""
    return torch.argsort(order, dim=0)


def combine(y: torch.Tensor, order: torch.Tensor,
            topi: torch.Tensor) -> torch.Tensor:
    """The experts' rows y (E, C, d) back in token order, (T, d): each
    token's rows added one after the other in ascending expert order, in
    y's dtype. ``order`` is the experts' queues (T, E), ``topi`` each
    token's chosen experts (T, k). Token t's slot in expert e's queue is
    its rank there; a chosen expert whose queue it did not make (rank >=
    C) reads a zero row appended at index E·C. On DTensors see
    :func:`_combine_on_shards`."""
    rank = _queue_rank(order)
    experts = torch.sort(topi, dim=1).values                # (T,k) ascending
    if is_dtensor(y):
        return _combine_on_shards(y, rank, experts)
    return _combine_rows(y, rank, experts)


def _combine_rows(y, rank, experts, e0: int = 0, c0: int = 0,
                  cap=None):
    """:func:`combine` of the rows y (E', C', d) of experts e0 .. e0+E'-1
    at their slots c0 .. c0+C'-1 of ``cap`` (default C'): a token's
    chosen expert outside them reads the zero row too."""
    e, cs, d = y.shape
    r = torch.gather(rank, 1, experts)
    mine = (r < cs) & (experts >= e0) & (experts < e0 + e)
    if c0 or cap is not None:
        r = r - c0
        mine = (r >= 0) & (r < cs) & (r + c0 < cap) & (experts >= e0) & (
            experts < e0 + e)
    rows = torch.where(mine, (experts - e0) * cs + r, e * cs)
    flat = torch.cat([y.reshape(e * cs, d), y.new_zeros((1, d))])
    out = torch.zeros((experts.shape[0], d), dtype=y.dtype, device=y.device)
    for j in range(rows.shape[1]):
        out = out + flat[rows[:, j]]
    return out


def _combine_on_shards(y, rank, experts):
    """:func:`_combine_rows` over DTensors, through ``local_map``, as the
    reference's XLA combines: each rank adds, for its tokens, the rows of
    its own experts (y's shard on the mesh dimension that splits the
    experts), a pending sum over that dimension that is then reduced
    (Megatron's all-reduce after a row-parallel product, of (T, d) and
    not of y's E·C rows). The tokens keep their shards on the other mesh
    dimensions. Across the experts' dimension the sum runs in another
    order than the plain combine's. With the experts whole (no dimension
    divides them) y is replicated and each rank adds its tokens' rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = y.device_mesh
    ep = [i for i, p in enumerate(y.placements) if p.is_shard(0)]
    tp = ep[0] if len(ep) == 1 else None
    tok = [Shard(0) if i != tp and p.is_shard(0) else Replicate()
           for i, p in enumerate(experts.placements)]
    yp = [Shard(0) if i == tp else Replicate() for i in range(mesh.ndim)]
    out = [Partial() if i == tp else p for i, p in enumerate(tok)]
    # y's gradient sums over the tokens' shards
    ygrad = [Partial() if p.is_shard() and i != tp else q
             for i, (p, q) in enumerate(zip(tok, yp))]

    def body(y, rank, experts):
        e0 = 0 if tp is None else mesh.get_local_rank(tp) * y.shape[0]
        return _combine_rows(y, rank, experts, e0)

    fn = local_map(body, out_placements=out, in_placements=(yp, tok, tok),
                   in_grad_placements=(ygrad, tok, tok), device_mesh=mesh)
    return settle(fn(place_on(y, mesh, yp), place_on(rank, mesh, tok),
                     place_on(experts, mesh, tok)))


def moe_dense_dispatch(x: torch.Tensor, params, mcfg: MoEConfig):
    """Reference Mesh-TF one-hot dispatch (tests only; O(T·E·C)
    memory)."""
    b, s, d = x.shape
    t, e = b * s, mcfg.n_experts
    x2d = x.reshape(t, d)
    cap = capacity(t, mcfg)
    probs, topi, sel, order = _routing(x2d, params["router"], mcfg, cap)
    rank = _queue_rank(order)
    keep = (rank < cap) & torch.isfinite(sel)
    disp = (F.one_hot(torch.where(keep, rank, cap), cap + 1)[..., :cap]
            .float() * keep[..., None])                     # (T,E,C)
    # the fp32 one-hot promotes the dispatch and the experts to fp32,
    # as in the reference
    dt = torch.promote_types(disp.dtype, x2d.dtype)
    xe = torch.einsum("tec,td->ecd", disp.to(dt), x2d.to(dt))
    y = _experts(xe, params)
    comb = disp * torch.where(keep, sel, 0.0)[..., None]
    out = torch.einsum("tec,ecd->td", comb.to(y.dtype), y)
    return out.reshape(b, s, d), probs


def moe_ffn(x, params, mcfg: MoEConfig, impl: str = "gather", opts=None):
    """The MoE FFN and its Switch-style load-balancing aux loss."""
    if impl == "ep_a2a":
        return moe_ep_a2a(x, params, mcfg, opts)
    if impl == "gather":
        y, probs = moe_gather(x, params, mcfg)
    elif impl == "dense_dispatch":
        y, probs = moe_dense_dispatch(x, params, mcfg)
    else:
        raise ValueError(impl)
    me = _expert_load(probs)                                # (E,)
    aux = mcfg.n_experts * torch.sum(me * me)
    return y, aux


def _expert_load(probs: torch.Tensor) -> torch.Tensor:
    """``probs.mean(0)``: each expert's mean gate over the tokens (the
    rows of probs (T, E), or its first two dimensions, (B, S, E)). On a
    DTensor whose tokens are split, each rank sums its rows through
    ``local_map``, a pending sum then reduced, and the backward gives
    each rank its rows' gradient, split as the rows are. Left to
    DTensor, the mean's gradient, a pending average over every token,
    meets the gates' and the router's backward runs on every token on
    every rank."""
    if not is_dtensor(probs):
        return probs.mean(0)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = probs.device_mesh
    tokens = tuple(range(probs.ndim - 1))      # (T, E), or (B, S, E)
    rows = [p if p.is_shard() and p.dim in tokens else Replicate()
            for p in probs.placements]
    out = [Partial() if p.is_shard() else Replicate() for p in rows]
    fn = local_map(lambda p: p.sum(tokens), out_placements=out,
                   in_placements=(rows,), in_grad_placements=(rows,),
                   device_mesh=mesh)
    return settle(fn(place_on(probs, mesh, rows))) / math.prod(
        probs.shape[:-1])


#: all-to-all exchanges made by :func:`moe_ep_a2a` (two a layer), beside
#: the kernels' launch counters
A2A_CALLS = 0


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(ep, ...) → (ep, ...): slice i to group rank i, slice j of the
    result from rank j. Differentiable (its transpose is itself)."""
    global A2A_CALLS
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    A2A_CALLS += 1
    return all_to_all_single_autograd(x.contiguous(), None, None, group)


class _SumOver(torch.autograd.Function):
    """``all_reduce(SUM)`` over a group, differentiable: the gradient is
    summed over the group too (the transpose of a replicated sum when
    each rank back-propagates its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _ep_local(x, params, mcfg: MoEConfig, ep: int, group):
    """The reference's ``shard_map`` body on this rank's tokens x (b,
    s_loc, d) and experts (E/ep of them): route locally, send each
    expert's (C, d) slots to its owner, run the local experts on every
    peer's slots, send the rows back and combine them. Returns y and
    this rank's aux loss (before the mean over ranks)."""
    b, s_loc, d = x.shape
    t, e = b * s_loc, mcfg.n_experts
    x2d = x.reshape(t, d)
    cap = capacity(t, mcfg)                     # per-expert C_e
    e_loc = e // ep
    probs, topi, sel, order = _routing(x2d, params["router"], mcfg, cap)
    chosen = order[:cap].T                      # (E, C)
    gatew = torch.gather(sel, 0, chosen.T).T
    live = torch.isfinite(gatew)
    gatew = torch.where(live, gatew, 0.0)

    send = x2d[chosen.reshape(-1)].reshape(e, cap, d)          # (E, C, d)
    send = send * live[..., None].to(send.dtype)
    # (E, C, d) → (ep, E_loc, C, d) → a2a → (ep, E_loc, C, d) where dim0
    # now indexes the SOURCE peer
    recv = _all_to_all(send.reshape(ep, e_loc, cap, d), group)
    xe = recv.transpose(0, 1).reshape(e_loc, ep * cap, d)
    y = _experts(xe, params)
    # reverse path: back to origin shards, original slot order
    y = y.reshape(e_loc, ep, cap, d).transpose(0, 1)
    back = _all_to_all(y, group).reshape(e, cap, d)
    back = back * gatew[..., None].to(back.dtype)
    out = combine(back, order, topi)
    me = probs.mean(0)
    aux = mcfg.n_experts * torch.sum(me * me)
    return out.reshape(b, s_loc, d), aux


def moe_ep_a2a(x, params, mcfg: MoEConfig, opts):
    """Expert-parallel MoE with explicit all-to-alls over the current mesh
    (:func:`repro_torch.parallel.sharding.use_mesh`).

    The production pattern moves only the ROUTED tokens: each rank
    routes its local tokens, sends (E, C_e) slots to the expert owners
    with one all-to-all, computes its local experts and reverses the
    all-to-all — wire bytes t_loc·topk·cf·d instead of T_global·d.

    Layout contract: x (B, S, d) placed ``P(dp_axes, ep_axis, None)``,
    experts ``P(ep_axis, None, None)``, the router replicated. DTensors
    are placed so, their local shards run the reference's ``shard_map``
    body, and y comes back a DTensor of x's layout and aux a replicated
    one; plain tensors are taken as they are on a one-rank mesh.
    Gradients flow through (the transpose of all_to_all is all_to_all);
    the aux loss is averaged over ``dp_axes + (ep_axis,)`` by a
    differentiable sum, as ``pmean`` does.
    """
    from repro_torch.parallel import sharding as sh
    mesh = sh.current_mesh()
    ep_axis, dp_axes = opts.ep_axis, opts.dp_axes
    dp = tuple(dp_axes) if isinstance(dp_axes, (tuple, list)) \
        else (dp_axes,)
    names = sh.axis_names(mesh)
    ep = mesh.size(names.index(ep_axis))
    if mcfg.n_experts % ep:
        raise ValueError(f"{mcfg.n_experts} experts do not split over "
                         f"{ep} ranks of {ep_axis!r}")
    specs = {"router": sh.P(), "w_gate": sh.P(ep_axis, None, None),
             "w_up": sh.P(ep_axis, None, None),
             "w_down": sh.P(ep_axis, None, None)}
    x_spec = sh.P(dp_axes, ep_axis, None)

    def local(t, spec):
        if sh.is_dtensor(t):
            return t.redistribute(mesh, sh.to_placements(spec, mesh)) \
                .to_local()
        if mesh.size() != 1:
            raise ValueError(
                f"moe_ep_a2a on a mesh of {mesh.size()} ranks takes "
                f"DTensors: a plain tensor does not say which part it is")
        return t

    y, aux = _ep_local(local(x, x_spec),
                       {k: local(params[k], sp) for k, sp in specs.items()},
                       mcfg, ep, mesh.get_group(ep_axis))
    for axis in dp + (ep_axis,):
        aux = _SumOver.apply(aux, mesh.get_group(axis))
    aux = aux / math.prod(mesh.size(names.index(a)) for a in dp + (ep_axis,))
    if sh.is_dtensor(x):
        from torch.distributed.tensor import DTensor, Replicate
        y = DTensor.from_local(y, mesh, sh.to_placements(x_spec, mesh),
                               run_check=False)
        aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return y, aux
