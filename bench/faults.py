"""Faults planted under the timed path, to show that the comparison
that decides ``correct`` catches each fault a cell can have. Each takes
the program's step and returns a broken one with the same call. One chip
runs no exchange between chips, so that fault has no cell yet."""
from __future__ import annotations

import torch


def unchanged(step):
    """A train step that returns the weights and state it was given."""
    def broken(params, state, batch):
        _, _, metrics = step(params, state, batch)
        return params, state, metrics
    return broken


def half_batch(step):
    """A train step that leaves out half of the batch's rows and takes
    the mean over the rest."""
    def broken(params, state, batch):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step(params, state, half)
    return broken


def stale(step):
    """A prefill that hands back the last request's logits (the first
    request's own)."""
    last = []

    def broken(params, batch):
        out = step(params, batch)
        if not last:
            last.append(out)
        prev, last[0] = last[0], out
        return prev
    return broken


def altered(step):
    """A prefill whose logits at one position (the middle) are altered
    where they are produced: shifted by one over the vocabulary."""
    def broken(params, batch):
        out = step(params, batch)
        mid = out.shape[1] // 2
        out[:, mid] = torch.roll(out[:, mid], 1, dims=-1)
        return out
    return broken


def half_prompts(step):
    """A prefill that computes the first half of the batch's prompts and
    hands their logits back for the other half too (a batch of two or
    more)."""
    def broken(params, batch):
        tokens = batch["tokens"]
        out = step(params, {"tokens": tokens[:max(1, tokens.shape[0] // 2)]})
        return torch.cat([out, out])[:tokens.shape[0]]
    return broken


#: the faults of each traffic kind
BY_KIND = {"train": {"unchanged": unchanged, "half_batch": half_batch},
           "prefill": {"stale": stale, "altered": altered,
                       "half_batch": half_prompts}}
