"""Spans put from outside around the program's layer entry points.

While :func:`named_spans` is active, each dispatcher of :data:`SPANS`
runs inside a span of its name, so the span reads the same whatever
implementation the dispatcher picks. Attention under autograd gets a
second span, ``attention.bwd``, opened by an identity on its output when
the backward reaches it and closed by an identity on q, k and v once
their gradients are all made: it covers the attention's backward
whatever computes it.

A span puts a marker on the device's stream where it opens and another
where it closes (:func:`mark`: one-thread kernels of names of their
own), and writes its name into the log it was given as it opens. The
spans do not nest and run one after the other on one stream, so the
k-th name of the log owns the kernels between the k-th pair of markers,
whoever launched them: the trace needs no host records, and a kernel
launched by a library through ``ctypes`` (K2) counts where it ran.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import List

import torch

#: (module, function, span name) of each layer's entry point
SPANS = (("repro_torch.models.layers", "attention", "attention.fwd"),
         ("repro_torch.models.moe", "moe_ffn", "moe_ffn"),
         ("repro_torch.train.optimizer", "update", "optimizer.update"))
BACKWARD = "attention.bwd"
NAMES = tuple(label for _, _, label in SPANS) + (BACKWARD,)
#: the names of the markers in a trace: where a span opens
#: (``torch.cuda._sleep``) and where it closes (``torch._assert_async``)
OPEN, CLOSE = "spin_kernel", "_assert_async_cuda_kernel"
_TRUE: list = []


def mark(close: bool = False) -> None:
    """A marker on the current stream: a one-thread kernel."""
    if not torch.cuda.is_available():
        return
    if not close:
        torch.cuda._sleep(0)
        return
    if not _TRUE:
        _TRUE.append(torch.ones((), dtype=torch.bool, device="cuda"))
    torch._assert_async(_TRUE[0])


class _OpenBackward(torch.autograd.Function):
    """The identity on the attention's output; its backward, the first
    of the attention's, opens the backward span."""

    @staticmethod
    def forward(ctx, out, box):
        ctx.box = box
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        ctx.box[1].append(BACKWARD)
        mark()
        ctx.box[0].append(True)
        return g, None


class _CloseBackward(torch.autograd.Function):
    """The identity on q, k, v; its backward, once all three gradients
    are made, closes the span."""

    @staticmethod
    def forward(ctx, box, q, k, v):
        ctx.box = box
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if ctx.box[0]:
            mark(close=True)
            ctx.box[0].pop()
        return None, gq, gk, gv


def _attention_spans(real, log: List[str]):
    def attention(q, k, v, *args, **kw):
        log.append("attention.fwd")
        mark()
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        if not grad:
            out = real(q, k, v, *args, **kw)
        else:
            box = ([], log)
            q, k, v = _CloseBackward.apply(box, q, k, v)
            out = _OpenBackward.apply(real(q, k, v, *args, **kw), box)
        mark(close=True)
        return out
    return attention


def _span(real, label, log: List[str]):
    def wrapped(*args, **kw):
        log.append(label)
        mark()
        out = real(*args, **kw)
        mark(close=True)
        return out
    return wrapped


@contextlib.contextmanager
def named_spans(log: List[str]):
    """While the block runs, every entry point of :data:`SPANS` runs
    inside its span, named in ``log``; the calls themselves go
    through."""
    saved = []
    for module, attr, label in SPANS:
        mod = importlib.import_module(module)
        real = getattr(mod, attr)
        wrapped = _attention_spans(real, log) if attr == "attention" \
            else _span(real, label, log)
        setattr(mod, attr, wrapped)
        saved.append((mod, attr, real))
    try:
        yield
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
