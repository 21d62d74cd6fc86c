"""Production mesh definitions — the reference package's
``repro.launch.mesh`` over a ``torch.distributed`` process group.

Every mesh is made by a FUNCTION (importing the module touches no
device or process group). Single-pod: (16, 16) = 256 ranks, axes
(data, model). Multi-pod: (2, 16, 16) = 512 ranks across 2 pods, axes
(pod, data, model); the ``pod`` axis carries only data parallelism.
The process group must exist first (``torch.distributed.
init_process_group`` with its world size and rank given); a mesh's
size must be the group's.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.parallel.sharding import axis_names


def _mesh(device, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise RuntimeError(
            f"a {shape} mesh {axes} needs a process group of {n} ranks; "
            f"{'none is initialised' if world is None else f'it has {world}'}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=DEFAULT_DEVICE):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def batch_axes(mesh) -> tuple:
    """The mesh axes that carry the batch (DP) dimension."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def make_debug_mesh(data: int = 1, model: int = 1, device=DEFAULT_DEVICE):
    """A (data, model) mesh over the current process group (tests and
    one-card runs)."""
    return _mesh(device, (data, model), ("data", "model"))
