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


def _experts(xe, params):
    """(E, C, d) → (E, C, d): each expert's SwiGLU on its slots, in
    xe's dtype (the weights promoted to it, as ``jnp.einsum`` does)."""
    def w(name):
        return params[name].to(xe.dtype)
    g = torch.bmm(xe, w("w_gate"))
    u = torch.bmm(xe, w("w_up"))
    return torch.bmm(F.silu(g) * u, w("w_down"))


def moe_gather(x: torch.Tensor, params, mcfg: MoEConfig):
    """x: (B,S,d) → (B,S,d), probs. Static-shape gather MoE; the
    combine adds each token's rows in ascending expert order."""
    b, s, d = x.shape
    t, e = b * s, mcfg.n_experts
    x2d = x.reshape(t, d)
    cap = capacity(t, mcfg)
    probs, topi, sel, order = _routing(x2d, params["router"], mcfg, cap)

    chosen = order[:cap].T                                  # (E,C) token ids
    gatew = torch.gather(sel, 0, chosen.T).T                # (E,C)
    live = torch.isfinite(gatew)
    gatew = torch.where(live, gatew, 0.0)

    xe = x2d[chosen.reshape(-1)].reshape(e, cap, d)         # (E,C,d) gather
    y = _experts(xe, params)
    y = y * gatew[..., None].to(y.dtype)
    return combine(y, order, topi).reshape(b, s, d), probs


def combine(y: torch.Tensor, order: torch.Tensor,
            topi: torch.Tensor) -> torch.Tensor:
    """The experts' rows y (E, C, d) back in token order, (T, d): each
    token's rows added one after the other in ascending expert order, in
    y's dtype. ``order`` is the experts' queues (T, E), ``topi`` each
    token's chosen experts (T, k). Token t's slot in expert e's queue is
    its rank there; a chosen expert whose queue it did not make (rank >=
    C) reads a zero row appended at index E·C."""
    e, cap, d = y.shape
    t = order.shape[0]
    rank = torch.empty((t, e), dtype=torch.long, device=y.device)
    rank.scatter_(0, order, torch.arange(t, device=y.device)[:, None]
                  .expand(t, e))
    experts = torch.sort(topi, dim=1).values                # (T,k) ascending
    r = torch.gather(rank, 1, experts)
    rows = torch.where(r < cap, experts * cap + r, e * cap)
    flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    out = torch.zeros((t, d), dtype=y.dtype, device=y.device)
    for j in range(rows.shape[1]):
        out = out + flat[rows[:, j]]
    return out


def moe_dense_dispatch(x: torch.Tensor, params, mcfg: MoEConfig):
    """Reference Mesh-TF one-hot dispatch (tests only; O(T·E·C)
    memory)."""
    b, s, d = x.shape
    t, e = b * s, mcfg.n_experts
    x2d = x.reshape(t, d)
    cap = capacity(t, mcfg)
    probs, topi, sel, order = _routing(x2d, params["router"], mcfg, cap)
    # rank of token within expert queue
    rank = torch.empty((t, e), dtype=torch.long, device=x.device)
    rank.scatter_(0, order, torch.arange(t, device=x.device)[:, None]
                  .expand(t, e))
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
    me = probs.mean(0)                                      # (E,)
    aux = mcfg.n_experts * torch.sum(me * me)
    return y, aux


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
