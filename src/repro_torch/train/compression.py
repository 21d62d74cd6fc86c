"""Gradient compression (distributed-optimization trick) — the reference
package's ``repro.train.compression`` over ``torch.distributed``.

Int8 uniform quantization with a per-leaf fp32 scale. The reduction is
done in int32 (no overflow for dp <= 2^23): an ``all_reduce(SUM)`` of
the codes and an ``all_reduce(MAX)`` of the scales over the group of one
mesh axis, the pattern a production runtime uses on the ``data`` axis
when gradients dominate the interconnect's traffic.

The wire format is the reference's: int32 codes, so the all-reduce
moves 4 bytes an element, twice a bf16 gradient's 2. The 4x cut of the
reference's docstring is modelled by the simulator's event model, not
realised on the wire (a deployment would pack int8 with a two-phase
reduce).

Error feedback (residual accumulation) keeps convergence unbiased.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import current_mesh
from repro_torch.train.tree import leaves, map_leaves, unflatten_like


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any) -> Any:
    return map_leaves(quantize_int8, grads)


def compressed_psum(grads: Any, axis_name: str) -> Any:
    """Quantize → int32 sum over the ranks of ``axis_name`` of the
    current mesh → dequantize with the largest scale → mean.

    The local view, like the reference's ``shard_map`` body: each rank
    passes its own gradients (plain tensors) and gets the mean back.
    """
    group = current_mesh().get_group(axis_name)
    n = dist.get_world_size(group)

    def one(g):
        q, scale = quantize_int8(g)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, group=group)
        # scales differ per rank: reduce with max for a conservative bound
        smax = scale.clone()
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return (tot.float() * smax / n).to(g.dtype)

    return map_leaves(one, grads)


def wire_bytes(grads: Any) -> int:
    """Bytes one rank puts into :func:`compressed_psum`'s all-reduces:
    the int32 codes and one fp32 scale a leaf."""
    return sum(4 * g.numel() + 4 for g in leaves(grads))


class ErrorFeedback:
    """Residual accumulator: g_sent = Q(g + e); e ← g + e − g_sent."""

    @staticmethod
    def init(grads: Any) -> Any:
        return map_leaves(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads)

    @staticmethod
    def apply(grads: Any, residual: Any):
        def one(g, e):
            target = g.float() + e
            q, scale = quantize_int8(target)
            sent = dequantize_int8(q, scale)
            return sent.to(g.dtype), target - sent
        pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(residual),
                                           strict=True)]
        return (unflatten_like(grads, [p[0] for p in pairs]),
                unflatten_like(grads, [p[1] for p in pairs]))
