"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version. CUDA sources live under ``csrc/`` and are compiled
with ``nvcc`` at first use (see :mod:`repro_torch.kernels.build`)."""
from __future__ import annotations

import torch


def refuse_autograd(op: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record ``op``: the kernels have no
    backward (nor has the reference's Pallas kernel, under whose
    ``jax.grad`` the same call raises). Their wrappers write a fresh
    tensor without a ``grad_fn``, so a gradient through them would be
    dropped without a word. Checked on every device, so a call that
    trains on CPU tensors cannot lose its gradient on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward: call it under torch.no_grad() or on "
            f"tensors that do not require grad (to train, use the "
            f"model's flash_torch attention and layers.rmsnorm)")
