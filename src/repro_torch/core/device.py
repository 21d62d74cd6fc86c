"""Device resolution for the port's entry points.

Every entry point that touches tensors takes an explicit ``device``
argument whose default is the card. Nothing falls back by itself: a
caller who wants the CPU says ``device="cpu"``; a caller who asks for
``cuda`` on a machine without one gets an error, not a slow answer.
"""
from __future__ import annotations

import torch

#: the default device of every entry point of the port
DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is
    asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch.cuda is not "
            f"available on this host; pass device='cpu' to run the "
            f"plain PyTorch path on the host")
    return dev
