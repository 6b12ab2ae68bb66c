"""Build and load the port's hand-written CUDA kernels.

Each ``tikejax_torch/csrc/<name>.cu`` exposes a plain C interface. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout and loaded with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: importing the package needs no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "the tikejax_torch CUDA kernels are not built and cannot be: no "
        "nvcc on PATH or under $CUDA_HOME//usr/local/cuda (a CUDA tensor "
        "needs the kernel library; CPU tensors use the plain versions)")


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    library path, the seconds spent compiling (0 when it existed) and
    the compiler's report (registers, shared memory and spills per kernel,
    from ``-Xptxas -v``; empty when it existed)."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{key[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, seconds, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path, _, _ = build(name)
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib
