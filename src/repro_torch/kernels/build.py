"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``csrc/`` has a plain C interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds into a shared library that
is loaded with :mod:`ctypes`. The library lands in a build directory
outside the package — ``build/repro_torch_kernels/`` at the root of the
checkout, or ``$REPRO_TORCH_BUILD_DIR`` — named by a hash of the source,
every header under ``csrc/`` and the flags, so an edited source or
header never loads a stale binary.

Nothing here runs when the package is imported: a machine without
``nvcc`` can import every module, and only asking for a kernel raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"

#: Hopper with the architecture-specific feature set (wgmma, setmaxnreg);
#: ``-Xptxas=-v`` reports each kernel's registers and spills
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: name -> (library path, seconds the compile took; 0.0 when reused)
BUILD_LOG: Dict[str, Tuple[str, float]] = {}
#: name -> what nvcc printed (ptxas's register and spill report), for
#: the libraries compiled by this process
NVCC_OUTPUT: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" \
        / "repro_torch_kernels"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels of repro_torch are compiled "
        "at first use and cannot be built on this host")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a hash of
    that source, every ``csrc/*.cuh`` header (any of them may be
    included) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(name: str) -> Tuple[Path, float]:
    """Build ``csrc/<name>.cu`` unless its library exists; returns the
    library's path and the seconds ``nvcc`` took (0.0 when reused)."""
    src = CSRC / f"{name}.cu"
    so = library_path(name)
    out_dir = so.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    if so.exists():
        return so, 0.0
    tmp = out_dir / f".{so.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)               # atomic: no reader sees a partial
    NVCC_OUTPUT[name] = proc.stdout + proc.stderr
    return so, seconds


def load_kernels(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Load the libraries of ``csrc/<name>.cu`` for every name, first
    compiling those not built yet — one ``nvcc`` per source, all started
    together. Raises on any build or load failure."""
    todo = [n for n in dict.fromkeys(names) if n not in _LOADED]
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            built = list(pool.map(_compile, todo))
        for name, (so, seconds) in zip(todo, built):
            _LOADED[name] = ctypes.CDLL(str(so))
            BUILD_LOG[name] = (str(so), seconds)
    return {n: _LOADED[n] for n in names}


def load_kernel(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, load
    it and return the handle. Raises on any build or load failure."""
    return load_kernels([name])[name]
