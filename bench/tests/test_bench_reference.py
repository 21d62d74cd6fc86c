"""The plain reference (``bench/reference/decoder.py``) on the CPU."""
import copy

import pytest
import torch

from bench import traffic, weights
from bench.kinds import prefill, train
from bench.reference import decoder

MOE = {"n_experts": 6, "top_k": 2, "d_ff_expert": 8,
       "capacity_factor": 1.0, "router_dtype": "float32"}


def moe_weights(d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    e, f = MOE["n_experts"], MOE["d_ff_expert"]
    return {"router": torch.randn(d, e, generator=g),
            "w_gate": torch.randn(e, d, f, generator=g) * 0.3,
            "w_up": torch.randn(e, d, f, generator=g) * 0.3,
            "w_down": torch.randn(e, f, d, generator=g) * 0.3}


def moe_by_token(x2d, p, moe):
    """A loop over tokens: token t gets expert e's gated SwiGLU where e
    is among its top_k and fewer than ``capacity`` tokens that chose e
    have a larger gate or an equal gate and a lower index."""
    probs = torch.softmax(x2d @ p["router"], dim=-1)
    t_n = x2d.shape[0]
    cap = decoder.capacity(t_n, moe)
    top, gate = [], []
    for t in range(t_n):
        order = sorted(range(moe["n_experts"]), key=lambda e: (-probs[t, e],
                                                               e))
        chosen = order[:moe["top_k"]]
        w = probs[t, chosen]
        top.append(chosen)
        gate.append(dict(zip(chosen, (w / w.sum()).tolist())))
    out = torch.zeros_like(x2d)
    for t in range(t_n):
        for e in top[t]:
            ahead = sum(1 for u in range(t_n) if e in gate[u] and (
                gate[u][e] > gate[t][e] or (gate[u][e] == gate[t][e]
                                            and u < t)))
            if ahead < cap:
                h = x2d[t]
                y = (torch.nn.functional.silu(h @ p["w_gate"][e])
                     * (h @ p["w_up"][e])) @ p["w_down"][e]
                out[t] += gate[t][e] * y
    return out


@pytest.mark.parametrize("tokens", [5, 24])
def test_moe_equals_a_loop_over_tokens(tokens):
    """At 24 tokens the capacity (8 slots) binds and tokens are dropped."""
    p = moe_weights()
    x = torch.randn(1, tokens, 16, generator=torch.Generator().manual_seed(1))
    got, _ = decoder.moe_ffn(x, p, MOE)
    want = moe_by_token(x[0], p, MOE)
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)


def test_moe_drops_past_the_capacity():
    p = moe_weights()
    x = torch.randn(1, 24, 16, generator=torch.Generator().manual_seed(1))
    _, top, _ = decoder.route(x[0], p["router"], MOE)
    counts = torch.bincount(top.flatten(), minlength=MOE["n_experts"])
    assert int(counts.max()) > decoder.capacity(24, MOE)


DROPLESS = dict(MOE, capacity_factor=None)


def every_pair(x2d, p, moe):
    """Each token's gated SwiGLU of every one of its top_k experts, with
    no capacity: every expert computed on every token, then gathered."""
    _, top, gates = decoder.route(x2d, p["router"], moe)
    h = torch.einsum("td,edf->tef", x2d, p["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, p["w_up"])
    y = torch.einsum("tef,efd->ted", torch.nn.functional.silu(h) * u,
                     p["w_down"])
    chosen = torch.gather(y, 1, top[:, :, None].expand(-1, -1, y.shape[-1]))
    return (chosen * gates[:, :, None]).sum(1)


def oversubscribed(tokens=24, seed=4):
    """Weights and rows where one router column sends every token to
    expert 0: a constant feature that only column 0 reads, strongly."""
    p = moe_weights(seed=seed)
    p["router"][0] = 0.0
    p["router"][0, 0] = 20.0
    x = torch.randn(1, tokens, 16, generator=torch.Generator().manual_seed(
        seed))
    x[..., 0] = 5.0
    return p, x


@pytest.mark.parametrize("case", ["random", "oversubscribed"])
def test_dropless_routing_keeps_every_token_expert_pair(case):
    p, x = oversubscribed()
    if case == "random":
        p = moe_weights()
        x = torch.randn(1, 24, 16, generator=torch.Generator().manual_seed(1))
    assert decoder.capacity(24, DROPLESS) == 24
    got, _ = decoder.moe_ffn(x, p, DROPLESS)
    torch.testing.assert_close(got[0], every_pair(x[0], p, DROPLESS),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tokens", [5, 24, 200])
def test_dropless_is_a_factor_that_never_binds_bit_for_bit(tokens):
    p, x = oversubscribed(tokens)
    factor = MOE["n_experts"] / MOE["top_k"] * (1 + 1e-6)
    never = dict(MOE, capacity_factor=factor)
    assert decoder.capacity(tokens, never) == tokens
    assert torch.equal(decoder.moe_ffn(x, p, DROPLESS)[0],
                       decoder.moe_ffn(x, p, never)[0])


def test_dropless_differs_from_a_capacity_where_an_expert_is_oversubscribed():
    p, x = oversubscribed()
    _, top, _ = decoder.route(x[0], p["router"], MOE)
    assert bool((top[:, 0] == 0).all())
    capped = dict(MOE, capacity_factor=1.25)
    assert decoder.capacity(24, capped) < 24
    dropless, _ = decoder.moe_ffn(x, p, DROPLESS)
    assert not torch.allclose(dropless, decoder.moe_ffn(x, p, capped)[0],
                              rtol=1e-3, atol=1e-3)


def tiny_qwen3(seed=6):
    """The tiny Qwen3 fixture in float32, its q/k norm scales drawn away
    from ones."""
    from bench import harness
    cfg = dict(harness.read_json(harness.BENCH / "tests" / "fixtures"
                                 / "configs" / "tiny_qwen3.json"),
               dtype="float32", init_std=0.2)
    w = weights.make(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for name in ("ln_q", "ln_k"):
        w["attn_layers"][name] = 1 + 0.5 * torch.randn(
            w["attn_layers"][name].shape, generator=g)
    return cfg, w


def block_by_hand(cfg, p, x):
    """One layer with the q/k norm written out: each head's values of q
    and of k over their root mean square, times the shared scale, head
    by head, then RoPE."""
    eps, hd, b, s = cfg["rms_norm_eps"], cfg["head_dim"], *x.shape[:2]
    h = decoder.rmsnorm(x, p["ln"], eps)
    q = (h @ p["wq"]).reshape(b, s, cfg["n_heads"], hd)
    k = (h @ p["wk"]).reshape(b, s, cfg["n_kv_heads"], hd)
    v = (h @ p["wv"]).reshape(b, s, cfg["n_kv_heads"], hd)

    def per_head(t, scale):
        out = torch.empty_like(t)
        for head in range(t.shape[2]):
            u = t[:, :, head]
            out[:, :, head] = u / torch.sqrt(u.pow(2).mean(-1, keepdim=True)
                                             + eps) * scale
        return out
    q = decoder.rope(per_head(q, p["ln_q"]), cfg["rope_theta"])
    k = decoder.rope(per_head(k, p["ln_k"]), cfg["rope_theta"])
    o = decoder.attention(q, k, v, None)
    x = x + o.reshape(b, s, -1) @ p["wo"]
    f = p["ffn"]
    y, _ = decoder.moe_ffn(decoder.rmsnorm(x, f["ln"], eps), f, cfg["moe"])
    return x + y


def test_qk_norm_is_a_per_head_rmsnorm_before_rope():
    cfg, w = tiny_qwen3()
    x = torch.randn(2, 12, 64, generator=torch.Generator().manual_seed(7))
    for i in range(cfg["n_layers"]):
        p = decoder.layer_of(w["attn_layers"], i)
        got, _ = decoder.block(cfg, p, x)
        torch.testing.assert_close(got, block_by_hand(cfg, p, x), rtol=1e-5,
                                   atol=1e-5)


def test_qk_norm_scales_other_than_ones_change_the_logits():
    cfg, w = tiny_qwen3()
    tokens = traffic.pool({"kind": "prefill", "batch": 1, "seq_len": 16,
                           "pool": 1}, cfg, 8, "cpu")[0]["tokens"]
    ones = dict(w, attn_layers=dict(
        w["attn_layers"], ln_q=torch.ones_like(w["attn_layers"]["ln_q"]),
        ln_k=torch.ones_like(w["attn_layers"]["ln_k"])))
    scaled = decoder.forward(cfg, w, tokens)
    plain = decoder.forward(cfg, ones, tokens)
    assert not torch.allclose(scaled, plain, rtol=1e-3, atol=1e-3)
    unnormed = decoder.forward(dict(cfg, qk_norm=False), ones, tokens)
    assert not torch.allclose(plain, unnormed, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("rows", [None, 5])
def test_attention_equals_a_loop_over_pairs(window, rows):
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 11, 4, 8, generator=g)
    k = torch.randn(2, 11, 2, 8, generator=g)
    v = torch.randn(2, 11, 2, 8, generator=g)
    got = decoder.attention(q, k, v, window, rows=rows)
    want = torch.zeros_like(q)
    for b in range(2):
        for h in range(4):
            for i in range(11):
                js = [j for j in range(i + 1) if window is None
                      or i - j < window]
                s = torch.stack([q[b, i, h] @ k[b, j, h // 2] for j in js])
                w = torch.softmax(s / 8 ** 0.5, dim=0)
                want[b, i, h] = sum(w[n] * v[b, j, h // 2]
                                    for n, j in enumerate(js))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_rope_rotates_pairs_of_halves():
    x = torch.randn(1, 6, 2, 8)
    y = decoder.rope(x, 1e4)
    torch.testing.assert_close(y[:, 0], x[:, 0])
    pairs = lambda t: t[..., :4] ** 2 + t[..., 4:] ** 2  # noqa: E731
    torch.testing.assert_close(pairs(y), pairs(x))


def tiny_dense():
    return {"arch": "h2o_danube_1_8b", "n_layers": 2, "d_model": 32,
            "n_heads": 4, "n_kv_heads": 2, "d_ff": 48, "vocab": 64,
            "sliding_window": 6, "rope_theta": 1e4, "rms_norm_eps": 1e-6,
            "dtype": "float32", "init_std": 0.2,
            "optimizer": {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                          "weight_decay": 0.1, "grad_clip": 1.0,
                          "warmup_steps": 2, "total_steps": 10,
                          "min_lr_frac": 0.1}}


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, in the graph)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def whole_loss(cfg, w, batch, aux_coef=0.01):
    """The loss of one graph through every layer, for autograd."""
    x = w["embed"][batch["tokens"].long()]
    aux = 0.0
    for i in range(cfg["n_layers"]):
        x, a = decoder.block(cfg, layer(w["attn_layers"], i), x)
        aux = aux + a
    x = decoder.rmsnorm(x, w["final_norm"], cfg["rms_norm_eps"])
    return decoder.cross_entropy(x @ w["head"], batch["labels"]) \
        + aux_coef * aux


@pytest.mark.parametrize("moe", [False, True])
def test_layerwise_backward_equals_autograd_of_the_whole(moe):
    cfg = tiny_dense()
    if moe:
        cfg["moe"] = dict(MOE, d_ff_expert=8, capacity_factor=2.0)
    layerwise_equals_autograd(cfg)


def test_layerwise_backward_equals_autograd_with_the_optional_keys():
    """Heads wider than d_model / n_heads, q/k norms with scales away
    from ones, and dropless routing."""
    cfg = dict(tiny_dense(), head_dim=16, qk_norm=True,
               moe=dict(MOE, d_ff_expert=8, capacity_factor=None))
    layerwise_equals_autograd(cfg, scales=True)


def layerwise_equals_autograd(cfg, scales=False):
    w = weights.make(cfg, 3, "cpu")
    if scales:
        g = torch.Generator().manual_seed(3)
        for name in ("ln_q", "ln_k"):
            w["attn_layers"][name] = 1 + 0.5 * torch.randn(
                w["attn_layers"][name].shape, generator=g)
    batch = traffic.pool({"kind": "train", "batch": 2, "seq_len": 10,
                          "pool": 1}, cfg, 3, "cpu")[0]
    loss, grads = decoder.loss_and_grads(cfg, w, batch)
    leaves = dict(decoder.leaves(w))
    params = {p: t.detach().clone().requires_grad_()
              for p, t in leaves.items()}
    tree: dict = {}
    for p, t in params.items():
        weights.set_path(tree, p, t)
    want = whole_loss(cfg, tree, batch)
    want.backward()
    torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=1e-6)
    for p, g in decoder.leaves(grads):
        torch.testing.assert_close(g, params[p].grad, rtol=1e-5, atol=1e-6)


def test_adamw_is_torchs_adamw_without_a_clip():
    cfg = tiny_dense()
    opt = dict(cfg["optimizer"], grad_clip=1e9, warmup_steps=0,
               total_steps=10 ** 9)
    p = {"w": torch.randn(5, 3)}
    ours = decoder.AdamW(opt, p)
    ref = torch.nn.Parameter(p["w"].clone())
    torch_opt = torch.optim.AdamW([ref], lr=opt["lr"], betas=(0.9, 0.95),
                                  eps=1e-8, weight_decay=0.1)
    for step in range(3):
        g = torch.randn(5, 3, generator=torch.Generator().manual_seed(step))
        ours.update(p, {"w": g})
        ref.grad = g.clone()
        torch_opt.step()
    torch.testing.assert_close(p["w"], ref.detach(), rtol=1e-6, atol=1e-7)


def test_lr_warms_up_then_decays():
    opt = tiny_dense()["optimizer"]
    lrs = [decoder.lr_at(opt, s) for s in range(12)]
    assert lrs[0] == pytest.approx(5e-3) and lrs[1] == pytest.approx(1e-2)
    assert lrs[10] == pytest.approx(1e-3) and lrs[11] == pytest.approx(1e-3)


def test_fp8_round_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = (decoder.fp8_round(x) - x).norm() / x.norm()
    e16 = (x.bfloat16().float() - x).norm() / x.norm()
    assert 0.01 < e8 < 0.05 and e16 < e8 / 8


@pytest.mark.parametrize("name", ["tiny_dense.train", "tiny_moe.prefill"])
def test_port_in_float32_agrees_with_the_reference(tiny, name):
    """The port's own path, in float32, against the reference: the
    reference computes what the port computes."""
    cell = tiny(name)
    cell.config = dict(cell.config, dtype="float32")
    batches = traffic.pool(cell.traffic, cell.config, 5, "cpu")
    if cell.kind == "prefill":
        w = weights.make(cell.config, 5, "cpu")
        got = prefill.program_step(cell)(w, batches[0])
        want = decoder.forward(cell.config, w, batches[0]["tokens"])
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        return
    step, init = train.program_step(cell, "cpu")
    got = train.readings(cell, 5, "cpu", step, init, batches)
    want = train.reference(cell, 5, "cpu", copy.copy(batches))
    checks = {c["name"]: c["value"] for c in train.compare(cell, got, want)}
    assert checks["loss_gap"] < 1e-6
    assert checks["grad_norm_gap"] < 1e-5
    assert checks["change_gap"] < 1e-4
