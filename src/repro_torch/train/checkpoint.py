"""Checkpoint/restore with manifest + atomic commit, in the reference
package's on-disk format (``repro.train.checkpoint``), so a checkpoint
written by either package restores in the other.

Layout (one directory per step):

    <dir>/step_000042/
        manifest.json      # step, leaf paths/shapes/dtypes
        arr_<i>.npy        # one file per leaf, in pytree order

Leaf paths are the reference's (:mod:`repro_torch.train.tree`): dict
keys, sequence indices and ``.``-prefixed NamedTuple fields joined by
``/``. numpy has no bf16: the reference writes a bf16 leaf as its raw
2-byte values under the ``.npy`` descr ``<V2`` (what numpy makes of
``ml_dtypes.bfloat16``) with dtype ``bfloat16`` in the manifest. The
port writes and reads the same bytes through a ``uint16`` view, without
``ml_dtypes``.

Fault-tolerance properties:
  * atomic: written to ``step_X.tmp`` then renamed — a crash mid-write
    never corrupts the latest complete checkpoint;
  * self-describing: restore validates shapes/dtypes against the target
    tree and fails loudly on config drift;
  * bounded: ``keep`` newest checkpoints retained;
  * resumable: ``latest_step`` scans the directory, so a restarted job
    continues from the last commit.

The manifest helpers (:func:`manifest_nbytes`, :func:`synthetic_manifest`)
are pure numpy: engine-side code sizes restore reads with them.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaf_paths, unflatten_like

#: the ``.npy`` descr of a bf16 leaf, as the reference's files carry it
BF16_DESCR = "<V2"


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def manifest_nbytes(manifest: Mapping) -> float:
    """Total bytes described by a checkpoint manifest — works on
    manifests written by :func:`save` and synthetic ones from
    :func:`synthetic_manifest` (pure numpy)."""
    total = 0.0
    for e in manifest["leaves"]:
        n = 1
        for s in e["shape"]:
            n *= int(s)
        total += n * _itemsize(e["dtype"])
    return float(total)


def synthetic_manifest(step: int, named_bytes: Mapping[str, float],
                       dtype: str = "float32") -> Dict:
    """A model-level manifest (no arrays on disk): one 1-D leaf per
    ``name -> nbytes`` entry, byte counts rounded to whole elements.
    Shaped exactly like :func:`save`'s ``manifest.json`` so consumers
    (restore-read sizing, tooling) use one accounting path for real and
    hypothetical checkpoints."""
    item = _itemsize(dtype)
    name = dtype if dtype == "bfloat16" else str(np.dtype(dtype))
    leaves = []
    for i, (path, nbytes) in enumerate(named_bytes.items()):
        leaves.append({"i": i, "path": str(path),
                       "shape": [max(0, int(round(float(nbytes) / item)))],
                       "dtype": name})
    return {"step": int(step), "leaves": leaves}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]       # torch.bfloat16 → bfloat16


def _write(path: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    bits = t.view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": tuple(bits.shape)})
        f.write(bits.tobytes())


def save(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write checkpoint atomically; returns the final path. ``keep``
    newest checkpoints are retained (``keep=0`` retains nothing)."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(leaf_paths(tree)):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        _write(os.path.join(tmp, f"arr_{i}.npy"), t)
        manifest["leaves"].append(
            {"i": i, "path": name, "shape": list(t.shape),
             "dtype": _dtype_name(t)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit

    # retention (keep=0 means the [:-0] slice would retain EVERYTHING;
    # spell the "delete all" case out)
    steps = sorted(all_steps(directory))
    for s in (steps[:-keep] if keep else steps):
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, tree: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``tree`` (shape/dtype validated),
    each leaf on the device of the leaf it replaces."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for name, leaf in leaf_paths(tree):
        e = by_path.get(name)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(os.path.join(path, f"arr_{e['i']}.npy"))
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs {want}")
        # a bf16 file reads back as raw 2-byte voids; the manifest names it
        got = e["dtype"] if arr.dtype.kind == "V" else str(arr.dtype)
        if got != _dtype_name(leaf):
            # a silent cast would hide a changed training config (and
            # quietly round fp32 moments to bf16 or vice versa)
            raise ValueError(
                f"dtype mismatch for {name}: ckpt {got} vs "
                f"{_dtype_name(leaf)}")
        if got == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(leaf.device))
    return unflatten_like(tree, out), step
