"""Build and load the port's hand-written CUDA kernels.

Each ``tikejax_torch/csrc/<name>.cu`` exposes a plain C interface. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout (or, where that
root cannot be written, as in an installed package, under the user's cache
directory) and loaded with ``ctypes``. The library's file name carries a
hash of the source, of every ``csrc/`` header it includes (directly or
through another header) and of the flags (``defines`` included: a source
may be built more than once, with different ``-D`` macros), so an edited
source or header is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source at once. Nothing here runs
at import time: importing the package needs no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def default_build_dir(root: Path | None = None) -> Path:
    """Where the libraries go: ``<root>/build/kernels`` when ``root`` (the
    directory that holds the package: the checkout) can be written,
    otherwise ``$XDG_CACHE_HOME/tikejax_torch/kernels`` (``~/.cache`` when
    the variable is unset)."""
    root = Path(__file__).resolve().parents[2] if root is None else root
    if os.access(root, os.W_OK):
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "tikejax_torch" / "kernels"


BUILD_DIR = default_build_dir()  # chosen once, at import
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("grad_fused", "fwd", "minf_fused", "grad_prb_fused", "adj",
           "adj_probe", "adj_residual", "fwd_quad_stats", "ls_objectives",
           "gather_probe_mul", "scatter_conj_probe", "adj_probe_reduce")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_LOADED: dict[tuple, ctypes.CDLL] = {}
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


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` followed by every file it includes with
    ``#include "..."``, directly or through another included file (paths
    relative to the including file). System headers are not followed."""
    todo = [CSRC / f"{name}.cu"]
    seen: list[Path] = []
    while todo:
        path = todo.pop(0).resolve()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return seen


def library_key(name: str, defines: tuple[str, ...] = ()) -> str:
    """Hash of the source, its included files and the flags (``defines``:
    macros as ``NAME=value`` strings, passed to nvcc as ``-D``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()


def _library(name: str, defines: tuple[str, ...] = ()) -> Path:
    return BUILD_DIR / f"lib{name}-{library_key(name, defines)[:16]}.so"


def build_all(names=KERNELS,
              defines: tuple[str, ...] = ()) -> dict[str, tuple[Path, float,
                                                                  str]]:
    """Compile every ``csrc/<name>.cu`` in ``names`` whose library does
    not exist, one ``nvcc`` process per source, all started together.
    Returns, per name, the library path, the seconds spent compiling (0
    when it existed) and the compiler's report (registers, shared memory
    and spills per kernel, from ``-Xptxas -v``; empty when it existed).
    ``defines`` are ``-D`` macros for every source of this call. Raises
    RuntimeError naming every source that failed."""
    out, started = {}, {}
    for name in names:
        lib = _library(name, defines)
        if lib.exists():
            out[name] = (lib, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (lib, tmp, proc, time.perf_counter())
    failed = []
    for name, (lib, tmp, proc, t0) in started.items():
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed building {name}.cu (exit "
                          f"{proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half
        out[name] = (lib, seconds, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str, defines: tuple[str, ...] = ()) -> tuple[Path, float,
                                                               str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; see
    :func:`build_all`."""
    return build_all((name,), defines)[name]


def kernel_reports(report: str) -> dict[str, dict[str, int]]:
    """nvcc's ``-Xptxas -v`` report by kernel: {mangled entry name:
    {'registers', 'spill_stores', 'spill_loads', 'stack', 'smem'}} (bytes
    but for the registers; ``smem`` is the static shared memory)."""
    out, current = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = out.setdefault(entry.group(1), dict(
                registers=0, spill_stores=0, spill_loads=0, stack=0, smem=0))
            continue
        if current is None:
            continue
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
            found = re.search(pattern, line)
            if found:
                current[key] = int(found.group(1))
    return out


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    with _LOCK:
        lib = _LOADED.get((name, tuple(defines)))
        if lib is None:
            path, _, _ = build(name, tuple(defines))
            lib = _LOADED[name, tuple(defines)] = ctypes.CDLL(str(path))
        return lib
