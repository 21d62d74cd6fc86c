"""The one generator of traffic: a mix file's parameters and the run's
seed in, a pool of batches on the device out.

A mix (``traffic/<name>.json``) states its ``kind`` (``train`` or
``prefill``: the driver in ``kinds/`` that runs it), the ``batch`` of
every batch and either one ``seq_len`` with the ``pool`` of distinct
batches made in set-up, or a fixed cycle of ``lengths``, one batch a
length, in the order given. The window cycles through the pool. Token
ids are uniform over the configuration's vocabulary. A training batch
carries the next token as each position's label.
"""
from __future__ import annotations

from typing import Dict, List

import torch

#: a seed of its own for the traffic, apart from the weights'
TRAFFIC_SALT = 0x5DEECE66D


def lengths(mix: dict) -> List[int]:
    """The sequence length of each batch of the pool, in order."""
    if "lengths" in mix:
        return list(mix["lengths"])
    return [mix["seq_len"]] * mix["pool"]


def pool(mix: dict, cfg: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The pool's batches of ``mix["batch"]`` rows, drawn in one call;
    all rows differ (with overwhelming probability)."""
    b, sizes = mix["batch"], lengths(mix)
    train = mix["kind"] == "train"
    gen = torch.Generator(device).manual_seed(
        (seed * 1_000_003 + TRAFFIC_SALT) % (1 << 63))
    ids = torch.randint(0, cfg["vocab"], (b, sum(sizes) + len(sizes) * train),
                        generator=gen, device=device, dtype=torch.int32)
    out = []
    for x in ids.split([s + train for s in sizes], dim=1):
        x = x.contiguous()
        out.append({"tokens": x[:, :-1], "labels": x[:, 1:]} if train
                   else {"tokens": x})
    return out


def shape(batch: Dict[str, torch.Tensor]):
    """(rows, sequence length) of a batch."""
    b, s = batch["tokens"].shape
    return int(b), int(s)
