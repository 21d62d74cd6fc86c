"""Random weights of a configuration, made on the device from the seed.

The tree is the port's parameter layout (``embed``, ``final_norm``,
``head`` and one stack ``attn_layers`` whose leaves carry the layer as
their first axis, the FFN or MoE nested under ``ffn``). Each stacked
leaf is drawn by one call from a generator of its own, seeded from the
run's seed and the leaf's path, so every layer gets its own draw and any
leaf can be made again alone. Matrices are normal(0, ``init_std``) in the
configuration's dtype, norm scales ones, biases zeros.

A file's optional keys add to the layout and move no leaf: ``head_dim``
sets the width of each query and KV head (else ``d_model // n_heads``),
and ``qk_norm`` adds the per-head q and k norm scales ``ln_q`` and
``ln_k``, of ``head_dim`` values each, to every layer.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterator, Tuple

import torch

from bench import work

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def layer_shapes(cfg: dict) -> Dict[str, object]:
    """One layer's leaves and their shapes (the FFN under ``ffn``)."""
    d, hd = cfg["d_model"], work.head_dim(cfg)
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    attn: Dict[str, object] = {"ln": (d,), "wq": (d, q), "wk": (d, kv),
                               "wv": (d, kv), "wo": (q, d)}
    if cfg.get("qkv_bias"):
        attn.update(bq=(q,), bk=(kv,), bv=(kv,))
    if cfg.get("qk_norm"):
        attn.update(ln_q=(hd,), ln_k=(hd,))
    moe = cfg.get("moe")
    if moe:
        e, f = moe["n_experts"], moe["d_ff_expert"]
        ffn = {"ln": (d,), "router": (d, e), "w_gate": (e, d, f),
               "w_up": (e, d, f), "w_down": (e, f, d)}
    else:
        f = cfg["d_ff"]
        ffn = {"ln": (d,), "w_gate": (d, f), "w_up": (d, f),
               "w_down": (f, d)}
    attn["ffn"] = ffn
    return attn


def shapes(cfg: dict) -> Dict[str, object]:
    """The whole tree's shapes, the layer stack's leaves with their
    leading layer axis."""
    d, v = cfg["d_model"], cfg["vocab"]

    def stack(tree):
        return {k: stack(s) if isinstance(s, dict) else
                (cfg["n_layers"], *s) for k, s in tree.items()}

    out: Dict[str, object] = {"embed": (v, d), "final_norm": (d,)}
    if not cfg.get("tie_embeddings"):
        out["head"] = (d, v)
    out["attn_layers"] = stack(layer_shapes(cfg))
    return out


def paths(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted path, leaf) of every leaf, in sorted order."""
    for k in sorted(tree):
        path = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            yield from paths(tree[k], path + ".")
        else:
            yield path, tree[k]


def leaf_seed(seed: int, path: str) -> int:
    """The generator seed of one leaf: the run's seed and the leaf's
    path, mixed into 63 bits."""
    return (seed * 0x9E3779B97F4A7C15 + zlib.crc32(path.encode())) % (1 << 63)


def make_leaf(cfg: dict, path: str, shape, seed: int,
              device) -> torch.Tensor:
    name = path.rsplit(".", 1)[-1]
    dtype = dtype_of(cfg)
    if name.startswith("ln") or name == "final_norm":
        return torch.ones(shape, dtype=dtype, device=device)
    if name.startswith("b"):
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, path))
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, cfg["init_std"], generator=gen)


def set_path(tree: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def make(cfg: dict, seed: int, device) -> dict:
    """The weights of ``cfg`` for ``seed`` on ``device``."""
    out: dict = {}
    for path, shape in paths(shapes(cfg)):
        set_path(out, path, make_leaf(cfg, path, shape, seed, device))
    return out

