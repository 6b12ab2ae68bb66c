"""ctypes bindings + numpy fallbacks for the native scanprep library.

``scanprep.cpp`` is compiled at first use into ``build/native/`` at the root
of the checkout (never beside the source), under a name that carries a hash
of the source, so an edited source is rebuilt and a stale library is never
loaded. Without a C++ compiler every function runs its numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "scanprep.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False


def _library() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libscanprep-{key}.so"


def _build(lib: Path) -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                 "-o", str(tmp)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half
            return True
        except (OSError, subprocess.SubprocessError):
            continue
    return False


def _load():
    """Compile (once, cached) and dlopen the native library; None if no
    toolchain is available."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _library()
            if not path.exists() and not _build(path):
                return None
            lib = ctypes.CDLL(str(path))
            lib.scanprep_validate.restype = ctypes.c_int64
            lib.scanprep_validate.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32)]
            lib.scanprep_overlap_counts.restype = None
            lib.scanprep_overlap_counts.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def have_native() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def validate_scan(scan, nz: int, n: int, nprb: int):
    """Floor float (..., 2) scan coords to int32 and bounds-check.

    Returns (scan_int, n_bad). Native when available; numpy fallback.
    """
    scan = np.ascontiguousarray(scan, np.float32)
    flat = scan.reshape(-1, 2)
    lib = _load()
    if lib is not None:
        out = np.empty_like(flat, dtype=np.int32)
        bad = lib.scanprep_validate(_ptr(flat, ctypes.c_float),
                                    flat.shape[0], nz, n, nprb,
                                    _ptr(out, ctypes.c_int32))
        return out.reshape(scan.shape), int(bad)
    out = np.floor(flat).astype(np.int32)
    y, x = out[:, 0], out[:, 1]
    bad = int(((y < 0) | (x < 0) | (y > nz - nprb) | (x > n - nprb)).sum())
    return out.reshape(scan.shape), bad


def overlap_counts_host(scan_int, nz: int, n: int, nprb: int):
    """Per-pixel probe coverage counts, O(nscan + nz*n) via a difference
    array (vs the O(nscan * nprb^2) device scatter)."""
    scan_int = np.ascontiguousarray(scan_int, np.int32).reshape(-1, 2)
    lib = _load()
    if lib is not None:
        counts = np.zeros((nz, n), np.float32)
        lib.scanprep_overlap_counts(_ptr(scan_int, ctypes.c_int32),
                                    scan_int.shape[0], nz, n, nprb,
                                    _ptr(counts, ctypes.c_float))
        return counts
    diff = np.zeros((nz + 1, n + 1), np.float32)
    for y, x in scan_int:
        if y < 0 or x < 0 or y + nprb > nz or x + nprb > n:
            continue
        diff[y, x] += 1
        diff[y, x + nprb] -= 1
        diff[y + nprb, x] -= 1
        diff[y + nprb, x + nprb] += 1
    return diff.cumsum(0).cumsum(1)[:nz, :n]
