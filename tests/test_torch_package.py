"""Packaging properties of the port: it imports no jax, its bridge keeps
dtypes, and a CUDA tensor never falls back to the plain path."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import tikejax
import tikejax_torch
from tikejax_torch.ops import fused
from tikejax_torch.utils import cuda_build, geometry_from, to_numpy, to_torch

PKG = Path(tikejax_torch.__file__).parent
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    [str(PKG)], prefix="tikejax_torch."))


def test_every_module_imports_without_jax():
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'tikejax.'))"
            " for k in sys.modules if sys.modules[k] is not None)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 14


def test_no_jax_import_in_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    sources = list(PKG.rglob("*.py"))
    assert sources
    for path in sources:
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float32,
                                   np.float64, np.int32])
def test_bridge_round_trip_keeps_dtype(dtype):
    x = (np.arange(24).reshape(2, 3, 4) * (1 + 0.5j
         if np.issubdtype(dtype, np.complexfloating) else 1)).astype(dtype)
    t = to_torch(x)
    back = to_numpy(t)
    assert back.dtype == x.dtype and t.device.type == "cpu"
    np.testing.assert_array_equal(back, x)
    t[0, 0, 0] = 7  # the tensor owns its memory
    assert x[0, 0, 0] == 0


def test_geometry_from_any_object_with_the_fields():
    g = tikejax.Geometry(nz=40, n=30, nscan=5, ndet=16, nprb=12, ntheta=2,
                         nmodes=3)
    gt = geometry_from(g)
    assert isinstance(gt, tikejax_torch.Geometry)
    for f in ("nz", "n", "nscan", "ndet", "nprb", "ntheta", "nmodes"):
        assert getattr(gt, f) == getattr(g, f)
    assert gt.farplane_shape == g.farplane_shape
    with pytest.raises(ValueError, match="nprb"):
        tikejax_torch.Geometry(nz=8, n=8, nscan=1, ndet=8, nprb=16)


def test_cuda_tensor_without_a_built_library_raises(monkeypatch, tmp_path):
    """A CUDA tensor reaching grad_fused must launch the kernel or raise:
    with no library built and no nvcc to build one, it raises, and neither
    counter moves (no silent fallback to the plain version)."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    fused._lib.cache_clear()
    kernel, plain = fused.grad_fused.launches, fused.grad_fused_reference.launches
    g = tikejax_torch.Geometry(nz=32, n=32, nscan=4, ndet=16, nprb=16)
    with FakeTensorMode():
        psi = torch.ones(g.psi_shape, dtype=torch.complex64, device="cuda")
        prb = torch.ones(g.prb_shape, dtype=torch.complex64, device="cuda")
        data = torch.ones(g.data_shape, dtype=torch.float32, device="cuda")
        scan = torch.zeros(g.scan_shape, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="not built.*nvcc"):
            fused.grad_fused(psi, data, scan, prb, g.ndet, "gaussian")
        with pytest.raises(TypeError, match="complex64"):
            fused.grad_fused(psi.to(torch.complex128), data, scan,
                             prb.to(torch.complex128), g.ndet, "gaussian")
    assert fused.grad_fused.launches == kernel
    assert fused.grad_fused_reference.launches == plain
    fused._lib.cache_clear()


def test_packaging_finds_the_port():
    from setuptools import find_packages

    found = find_packages(str(PKG.parent), include=["tikejax*"])
    assert "tikejax_torch" in found and "tikejax_torch.ops" in found
