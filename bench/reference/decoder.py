"""A plain decoder-only transformer in PyTorch, written from the
published descriptions of its parts, as the benchmark's reference.

Pre-norm blocks: RMSNorm (Zhang & Sennrich 2019), grouped-query
attention (Ainslie et al. 2023) with rotary position embeddings (Su et
al. 2021, rotating the two halves of each head) under a causal and
optional sliding-window mask, then a SwiGLU FFN (Shazeer 2020) or a
mixture of SwiGLU experts routed as the configuration file's ``moe``
states; a final RMSNorm and an untied head; the mean cross-entropy of
next-token labels; AdamW (Loshchilov & Hutter 2019) with a global-norm
clip and a warm-up then cosine rate, each parameter stored back in the
configuration's dtype after its update.

Three keys of the file are optional, and a file that leaves them out
gets the block above unchanged:

* ``head_dim``: the width of each query and KV head, where it is not
  ``d_model / n_heads`` (Qwen3-30B-A3B: 128 over a hidden size of 2048
  and 32 heads; its ``config.json``);
* ``qk_norm``: an RMSNorm over each head's ``head_dim`` values of q and
  of k, after the projections and before RoPE, at ``rms_norm_eps`` and
  with a learned scale of ``head_dim`` values that the heads share
  (``ln_q``, ``ln_k``; Qwen3 technical report, arXiv:2505.09388);
* ``moe.capacity_factor`` null: routing without a capacity, each token
  run on every one of its ``top_k`` experts (Qwen3's released MoE
  block; "dropless", Gale et al. 2022, arXiv:2211.15841).

Everything is computed in float32 (TF32 off) from the configuration
file's numbers and the weights the benchmark made; nothing of the
program under test is imported. A :class:`Numerics` of ``"fp8"`` runs
every product of the bf16 model with its operands rounded to float8
e4m3 (one scale a tensor), and the fp32 router in bf16: the reference
in the next precision below the configuration's, the control of the
comparison that decides ``correct``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")
FP8_MAX = 448.0


def no_tf32() -> None:
    """float32 products in float32: the reference's precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest
    magnitude to e4m3's largest), back in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` of float8-rounded operands; backward likewise, the
    incoming gradient rounded too. ``a`` (..., m, k), ``b`` (..., k, n)
    with the same leading dimensions, or ``b`` 2-D."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g)
        ga = gq @ bq.transpose(-1, -2)
        if bq.dim() == 2 and aq.dim() > 2:
            gb = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:
            gb = aq.transpose(-1, -2) @ gq
        return ga, gb


class Numerics:
    """How the reference multiplies: ``"fp32"`` (the reference) or
    ``"fp8"`` (its control)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def router(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return (x.bfloat16() @ w.bfloat16()).float()
        return x @ w


FP32 = Numerics("fp32")


def f32(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of ``t``, apart from any graph."""
    return t.detach().to(torch.float32, copy=True)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1: each head's first half and
    second half rotated together by angle pos · theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: Optional[int], num: Numerics = FP32,
              rows: Optional[int] = None) -> torch.Tensor:
    """Causal grouped-query attention: q (B, S, H, hd), k and v
    (B, S, KH, hd); query head h reads KV head h // (H / KH). Query i
    sees key j when j <= i and i - j < window. ``rows`` splits the
    queries into blocks of that many (no gradient needed)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    qh = q.transpose(1, 2)                                   # (B,H,S,hd)
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    step = rows or s
    outs = []
    for r0 in range(0, s, step):
        i = torch.arange(r0, min(r0 + step, s), device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        keep = j <= i
        if window is not None:
            keep = keep & (i - j < window)
        scores = num.mm(qh[:, :, r0:r0 + step], kh.transpose(-1, -2))
        scores = (scores * hd ** -0.5).masked_fill(~keep, NEG_INF)
        outs.append(num.mm(torch.softmax(scores, dim=-1), vh))
    return torch.cat(outs, dim=2).transpose(1, 2)


def swiglu(x, w_gate, w_up, w_down, num: Numerics = FP32):
    return num.mm(F.silu(num.mm(x, w_gate)) * num.mm(x, w_up), w_down)


def capacity(n_tokens: int, moe: dict) -> int:
    """Slots an expert, as the configuration's routing states; with a
    ``capacity_factor`` of ``None``, every token: nothing is dropped."""
    if moe["capacity_factor"] is None:
        return n_tokens
    c = int(n_tokens * moe["top_k"] * moe["capacity_factor"]
            / moe["n_experts"])
    return min(n_tokens, max(8, (c + 7) // 8 * 8))


def route(x2d: torch.Tensor, router: torch.Tensor, moe: dict,
          num: Numerics = FP32):
    """(probs (T, E), chosen experts (T, k), their gates (T, k)): the
    top_k by descending probability, ties to the lower expert, gates
    renormalised to sum 1."""
    probs = torch.softmax(num.router(x2d, router), dim=-1)
    top = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :moe["top_k"]]
    gates = torch.gather(probs, 1, top)
    return probs, top, gates / gates.sum(-1, keepdim=True)


def moe_ffn(x: torch.Tensor, p: dict, moe: dict, num: Numerics = FP32):
    """x (B, S, d) -> (B, S, d) and the load-balance loss: each expert
    keeps the ``capacity`` tokens of highest gate among those that chose
    it (ties to the lower token), runs its SwiGLU on them, and adds the
    gate-weighted rows to their tokens; dropped tokens get nothing from
    that expert."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    probs, top, gates = route(x2d, p["router"], moe, num)
    cap = capacity(b * s, moe)
    out = torch.zeros_like(x2d)
    for e in range(moe["n_experts"]):
        tok, slot = (top == e).nonzero(as_tuple=True)        # ascending tok
        if tok.numel() == 0:
            continue
        g = gates[tok, slot]
        keep = torch.sort(-g.detach(), stable=True).indices[:cap]
        tok, g = tok[keep], g[keep]
        y = swiglu(x2d[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                   num)
        out = out.index_add(0, tok, y * g[:, None])
    load = probs.mean(0)
    return out.reshape(b, s, d), moe["n_experts"] * (load * load).sum()


def block(cfg: dict, p: dict, x: torch.Tensor, num: Numerics = FP32,
          rows: Optional[int] = None):
    """One pre-norm layer on x (B, S, d) -> (x, the MoE's aux loss)."""
    eps = cfg["rms_norm_eps"]
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    b, s, _ = x.shape
    h = rmsnorm(x, p["ln"], eps)
    q, k, v = (num.mm(h, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.get("qkv_bias"):
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd)
    if cfg.get("qk_norm"):
        q, k = rmsnorm(q, p["ln_q"], eps), rmsnorm(k, p["ln_k"], eps)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attention(q, k, v.reshape(b, s, -1, hd), cfg.get("sliding_window"),
                  num, rows)
    x = x + num.mm(o.reshape(b, s, -1), p["wo"])
    f = p["ffn"]
    h = rmsnorm(x, f["ln"], eps)
    if cfg.get("moe"):
        y, aux = moe_ffn(h, f, cfg["moe"], num)
    else:
        y, aux = swiglu(h, f["w_gate"], f["w_up"], f["w_down"], num), \
            x.new_zeros(())
    return x + y, aux


def layer_of(stack: dict, i: int) -> dict:
    return {k: layer_of(v, i) if isinstance(v, dict) else f32(v[i])
            for k, v in stack.items()}


def head_of(cfg: dict, w: dict) -> torch.Tensor:
    return w["embed"].T if cfg.get("tie_embeddings") else w["head"]


@torch.no_grad()
def forward(cfg: dict, w: dict, tokens: torch.Tensor,
            num: Numerics = FP32, rows: int = 1024) -> torch.Tensor:
    """Logits (B, S, V) in float32, a layer at a time: each layer's
    weights made float32 only while it runs."""
    x = f32(w["embed"][tokens.long()])
    for i in range(cfg["n_layers"]):
        x, _ = block(cfg, layer_of(w["attn_layers"], i), x, num, rows)
    x = rmsnorm(x, f32(w["final_norm"]), cfg["rms_norm_eps"])
    return num.mm(x, f32(head_of(cfg, w)))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean over labels >= 0 of -log softmax(logits)[label]."""
    flat = logits.reshape(-1, logits.shape[-1])
    return F.cross_entropy(flat, labels.reshape(-1).long(), ignore_index=-1)


def lr_at(opt: dict, step: int) -> float:
    """The rate of 0-based step ``step``: linear warm-up over
    ``warmup_steps``, then cosine decay to ``min_lr_frac`` of ``lr`` by
    ``total_steps``."""
    warm = min((step + 1) / max(1, opt["warmup_steps"]), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def leaves(tree: dict, prefix: str = ""):
    """(dotted path, tensor) of every leaf, in sorted order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree[k]
    tree[last] = value


def loss_and_grads(cfg: dict, w: dict, batch: Dict[str, torch.Tensor],
                   num: Numerics = FP32, aux_coef: float = 0.01):
    """(loss, float32 gradient tree) of the mean cross-entropy plus
    ``aux_coef`` times the layers' load-balance losses. The forward runs
    a layer at a time without a graph, keeping each layer's input; the
    backward runs each layer again under autograd, last to first, so one
    layer's activations are live at a time."""
    tokens, labels = batch["tokens"], batch["labels"]
    n = cfg["n_layers"]
    with torch.no_grad():
        xs = [f32(w["embed"][tokens.long()])]
        aux = torch.zeros((), device=tokens.device)
        for i in range(n):
            x, a = block(cfg, layer_of(w["attn_layers"], i), xs[-1], num)
            xs.append(x)
            aux = aux + a
    grads: dict = {"attn_layers": {}}
    with torch.enable_grad():
        x = xs[-1].requires_grad_()
        fn = f32(w["final_norm"]).requires_grad_()
        head = f32(head_of(cfg, w)).requires_grad_()
        ce = cross_entropy(num.mm(rmsnorm(x, fn, cfg["rms_norm_eps"]), head),
                           labels)
        ce.backward()
    grads["final_norm"] = fn.grad
    g_x = x.grad
    g_head = head.grad
    xs[-1] = None
    stack_grads: dict = {}
    for i in reversed(range(n)):
        with torch.enable_grad():
            x_in = xs[i].requires_grad_()
            lp = layer_of(w["attn_layers"], i)
            named = list(leaves(lp))
            for _, t in named:
                t.requires_grad_()
            out, a = block(cfg, lp, x_in, num)
            if a.requires_grad:
                torch.autograd.backward([out, a],
                                        [g_x, torch.full_like(a, aux_coef)])
            else:
                out.backward(g_x)
        g_x = x_in.grad
        xs[i] = None
        for path, t in named:
            stack_grads.setdefault(path, [None] * n)[i] = t.grad
    for path, per_layer in stack_grads.items():
        node = grads["attn_layers"]
        *head_keys, last = path.split(".")
        for k in head_keys:
            node = node.setdefault(k, {})
        node[last] = torch.stack(per_layer)
    g_embed = torch.zeros(w["embed"].shape, dtype=torch.float32,
                          device=g_x.device)
    g_embed.index_add_(0, tokens.reshape(-1).long(),
                       g_x.reshape(-1, g_x.shape[-1]))
    if cfg.get("tie_embeddings"):
        g_embed += g_head.T
    else:
        grads["head"] = g_head
    grads["embed"] = g_embed
    return ce.detach() + aux_coef * aux, grads


class AdamW:
    """AdamW over a tree: float32 moments, a global-norm clip, weight
    decay added to the Adam direction on every leaf, each parameter
    updated in float32 and stored back in its own dtype."""

    def __init__(self, opt: dict, params: dict):
        self.opt, self.step = opt, 0
        self.mu = {p: torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device) for p, t in leaves(params)}
        self.nu = {p: torch.zeros_like(m) for p, m in self.mu.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> Dict[str, float]:
        """Updates ``params`` in place; returns the norms of each leaf's
        clipped gradient as the update used it (:func:`leaf_norms`)."""
        o = self.opt
        gl = dict(leaves(grads))
        gnorm = torch.sqrt(sum(g.square().sum() for g in gl.values()))
        scale = torch.clamp(o["grad_clip"] / (gnorm + 1e-9), max=1.0)
        lr = lr_at(o, self.step)
        self.step += 1
        c1, c2 = 1 - o["b1"] ** self.step, 1 - o["b2"] ** self.step
        used = {}
        for path, p in list(leaves(params)):
            g = gl[path] * scale
            used.update(leaf_norms({path: g}))
            m = self.mu[path].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v = self.nu[path].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            delta = (m / c1) / (torch.sqrt(v / c2) + o["eps"]) \
                + o["weight_decay"] * p.float()
            _set(params, path, (p.float() - lr * delta).to(p.dtype))
        return used


def leaf_norms(tree: dict) -> Dict[str, float]:
    """The float32 norm of every leaf, a stacked leaf (under
    ``attn_layers``) taken layer by layer as ``path[i]``."""
    out = {}
    for path, t in leaves(tree):
        if path.startswith("attn_layers."):
            norms = torch.linalg.vector_norm(
                t.float().reshape(t.shape[0], -1), dim=1).tolist()
            out.update({f"{path}[{i}]": v for i, v in enumerate(norms)})
        else:
            out[path] = float(torch.linalg.vector_norm(t.float()))
    return out


def train(cfg: dict, opt: dict, w: dict, batches: List[dict],
          num: Numerics = FP32):
    """``len(batches)`` steps from the weights ``w`` (changed in place).
    Returns the losses, the norms of the first step's clipped gradient
    and of its raw gradient, by leaf (:func:`leaf_norms`)."""
    adam = AdamW(opt, w)
    losses, first, raw = [], None, None
    for batch in batches:
        loss, grads = loss_and_grads(cfg, w, batch, num)
        losses.append(float(loss))
        used = adam.update(w, grads)
        if first is None:
            first, raw = used, leaf_norms(grads)
        del grads
    return losses, first, raw
