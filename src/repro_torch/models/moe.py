"""Mixture-of-Experts FFN in PyTorch: the port of the reference
package's ``repro.models.moe``, static shapes, capacity-factor routing.

Two implementations, as there:

* ``gather`` (default): per-expert top-capacity token selection by a
  sort over tokens; tokens over capacity are dropped and pass through
  the residual.
* ``dense_dispatch``: Mesh-TF style one-hot dispatch, the same math,
  the small-scale reference of the tests (memory O(T·E·C)).

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

import torch
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


def moe_ep_a2a(x, params, mcfg: MoEConfig, opts):
    """Expert parallelism with an explicit all-to-all: needs a process
    group and expert sharding, which come with ``parallel/sharding``."""
    raise NotImplementedError(
        "moe_impl='ep_a2a' needs a process group and sharded experts; "
        "ROADMAP.md Queue 1 lists it with parallel/sharding")
