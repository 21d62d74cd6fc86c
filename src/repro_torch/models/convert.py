"""Carry a parameter tree (and an AdamW state) of the reference package
over to the port.

The reference keeps its parameters as a pytree of arrays — nested dicts,
per-layer weights stacked over a leading layer axis, the FFN under
``ffn``, an optional ``head`` and optional ``bq/bk/bv``. The port's
models use the same names and layouts (:mod:`repro_torch.models.lm`),
so the conversion is value for value: no transpose, and no cast unless
``dtype`` asks for one. It takes the tree as nested dicts of numpy
arrays (``np.asarray`` of each leaf), so this module needs nothing of
the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.train.optimizer import AdamWState


def _is_bfloat16(dtype: np.dtype) -> bool:
    """``ml_dtypes.bfloat16`` (what ``np.asarray`` gives for a bf16 JAX
    array), recognised without importing ``ml_dtypes``."""
    return dtype.name == "bfloat16" and dtype.itemsize == 2


def _tensor(a: Any) -> torch.Tensor:
    """A CPU tensor holding exactly the values of ``a``, bf16 included:
    ``torch.from_numpy`` refuses ``ml_dtypes.bfloat16``, so its bits are
    viewed as ``uint16`` and then as ``torch.bfloat16``. A read-only or
    strided array is copied first (``torch.from_numpy`` shares memory)."""
    a = np.require(a, requirements=["C", "W"])
    if _is_bfloat16(a.dtype):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(tree: Mapping[str, Any], device=DEFAULT_DEVICE,
                          dtype: Optional[torch.dtype] = None
                          ) -> Mapping[str, Any]:
    """The port's parameters from a reference parameter tree of numpy
    arrays, on ``device`` (its copies own their memory); cast to
    ``dtype`` only when one is given."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        t = _tensor(node)
        return t.to(device=dev, dtype=dtype, copy=True)

    return convert(tree)


def optimizer_state_from_reference(state: Any, device=DEFAULT_DEVICE
                                   ) -> AdamWState:
    """The port's :class:`AdamWState` from the reference's (``step`` and
    the ``mu``/``nu`` trees, leaves as numpy arrays), on ``device``: the
    same step and bit-identical fp32 moments."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step=step,
                      mu=params_from_reference(state.mu, device=dev),
                      nu=params_from_reference(state.nu, device=dev))
