"""Packaging properties of the port: it imports no jax, its bridge keeps
dtypes, and a CUDA tensor never falls back to the plain path."""

import ctypes
import inspect
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")
from torch._subclasses.fake_tensor import FakeTensorMode

import tikejax
import tikejax_torch
from tikejax_torch.ops import _launch, fused, kernels, lbfgs, linesearch
from tikejax_torch.utils import cuda_build, geometry_from, to_numpy, to_torch

PKG = Path(tikejax_torch.__file__).parent
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    [str(PKG)], prefix="tikejax_torch."))


def cpu(x):
    """The array as a CPU tensor: the bridge's default device is the card."""
    return to_torch(x, device="cpu")


def test_every_module_imports_without_jax():
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'tikejax.'))"
            " for k in sys.modules if sys.modules[k] is not None)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 14
    assert {"tikejax_torch.parallel", "tikejax_torch.parallel.sharding",
            "tikejax_torch.parallel._ranks", "tikejax_torch.parallel._jobs",
            "tikejax_torch.parallel._dryrun",
            "tikejax_torch.graft_entry"} <= set(MODULES)


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
    t = cpu(x)
    back = to_numpy(t)
    assert back.dtype == x.dtype and t.device.type == "cpu"
    np.testing.assert_array_equal(back, x)
    t[0, 0, 0] = 7  # the tensor owns its memory
    assert x[0, 0, 0] == 0


def test_simulation_and_bridge_default_to_the_card():
    """make_problem (and the simulation functions under it) and to_torch
    build on "cuda" unless the caller asks for another device; without a
    card that raises, and nothing falls back to the CPU."""
    from tikejax_torch.models import simulate

    for fn in (simulate.make_object, simulate.make_probe,
               simulate.raster_scan, simulate.make_problem, to_torch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    g = tikejax_torch.Geometry(nz=32, n=32, nscan=4, ndet=16, nprb=16)
    if torch.cuda.is_available():
        assert to_torch(np.zeros(3)).device.type == "cuda"
        gen = torch.Generator(device="cuda").manual_seed(0)
        assert simulate.make_problem(gen, g)[3].device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        to_torch(np.zeros(3))
    with pytest.raises((RuntimeError, AssertionError)):
        simulate.make_problem(torch.Generator().manual_seed(0), g)
    assert simulate.make_problem(torch.Generator().manual_seed(0), g,
                                 device="cpu")[3].device.type == "cpu"


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
    _launch.lib.cache_clear()
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
    _launch.lib.cache_clear()


def test_packaging_finds_the_port():
    from setuptools import find_packages

    found = find_packages(str(PKG.parent), include=["tikejax*"])
    assert "tikejax_torch" in found and "tikejax_torch.ops" in found
    assert "tikejax_torch.parallel" in found


def test_library_key_covers_included_headers(monkeypatch, tmp_path):
    """The built library's name hashes the source, every csrc header it
    includes (directly or through another header) and the flags: editing
    a header changes the key, so a stale library is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    assert [p.name for p in cuda_build.sources("k")] == ["k.cu", "a.cuh",
                                                         "b.cuh"]
    keys = [cuda_build.library_key("k")]
    (csrc / "b.cuh").write_text("// b, edited\n")
    keys.append(cuda_build.library_key("k"))
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a\n')
    keys.append(cuda_build.library_key("k"))
    assert len(set(keys)) == 3
    assert cuda_build.library_key("k") == keys[-1]


def test_every_kernel_source_uses_the_shared_header():
    for name in cuda_build.KERNELS:
        names = [p.name for p in cuda_build.sources(name)]
        assert names == [f"{name}.cu", "dft_frame.cuh"], names


# The ctypes type of each C parameter type of the kernels' interface.
_CTYPE = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
          "double": ctypes.c_double, "int*": ctypes.POINTER(ctypes.c_int)}


@pytest.mark.parametrize("name", cuda_build.KERNELS)
def test_bound_entry_points_match_the_sources(name):
    """``_launch.ENTRIES[name]`` lists every entry point that
    ``csrc/<name>.cu`` defines, each with the C parameters' types, and
    the stream last where it launches a kernel; the FFT entry that
    ``_launch.fft_entry`` names for either body is one of them."""
    text = (PKG / "csrc" / f"{name}.cu").read_text()
    found = dict(re.findall(r"^int (tk_\w+)\(([^)]*)\)", text, re.MULTILINE))
    assert set(found) == set(_launch.ENTRIES[name])
    if f"tk_{name}_fft" in found:
        for body in ("fft_smem", "fft_regs"):
            symbol = _launch.fft_entry(name, body)
            assert {symbol, f"{symbol}_blocks_per_sm"} <= set(found)
    for symbol, argtypes in _launch.ENTRIES[name].items():
        params = [" ".join(p.split()[:-1]).replace("const ", "").replace(
            " *", "*") for p in found[symbol].split(",") if p.strip()]
        want = [_CTYPE.get(p, ctypes.c_void_p) for p in params]
        if _launch.takes_stream(symbol):
            assert params[-1] == "void*", (symbol, params)
            want = want[:-1]
        assert want == argtypes, (symbol, params)


def _wrapper_inputs(c):
    """The tiny inputs of the kernel wrappers, complex ones of dtype ``c``
    (1 angle, 2 positions, 1 mode, a 4^2 probe, 16^2 detector and object)."""
    def z(*shape, dtype=c):
        return torch.zeros(shape, dtype=dtype)

    return dict(psi=z(1, 16, 16), prb=z(1, 1, 4, 4),
                scan=z(1, 2, 2, dtype=torch.int32),
                data=z(1, 2, 16, 16, dtype=torch.float32),
                far=z(1, 2, 1, 16, 16), fd=z(1, 2, 1, 16, 16),
                near=z(1, 2, 1, 4, 4), gammas=z(2, dtype=torch.float32),
                S=z(2, 1, 16, 16), Y=z(2, 1, 16, 16), g=z(1, 16, 16),
                gp=z(1, 16, 16), dp=z(1, 16, 16))


# Each kernel wrapper: (its call on the inputs, the input that goes to
# another device in the two-device case).
_WRAPPERS = {
    "grad_fused": (lambda x: fused._grad_fused_cuda(
        x["psi"], x["data"], x["scan"], x["prb"], 16, "gaussian", None),
        "scan"),
    "minf_fused": (lambda x: fused._minf_fused_cuda(
        x["psi"], x["data"], x["scan"], x["prb"], 16, "gaussian", None),
        "scan"),
    "fwd": (lambda x: fused._fwd_cuda(x["psi"], x["scan"], x["prb"], 16,
                                      None), "scan"),
    "grad_prb_fused": (lambda x: fused._grad_prb_fused_cuda(
        x["psi"], x["data"], x["scan"], x["prb"], 16, "gaussian"), "scan"),
    "adj": (lambda x: fused._adj_cuda(x["far"], x["scan"], x["prb"], 16, 16),
            "scan"),
    "adj_probe": (lambda x: fused._adj_probe_cuda(x["far"], x["scan"],
                                                  x["psi"], 4), "scan"),
    "adj_residual": (lambda x: fused._adj_residual_cuda(
        x["far"], x["data"], x["scan"], x["prb"], 16, 16, "gaussian"),
        "scan"),
    "fwd_quad_stats": (lambda x: fused._fwd_quad_stats_cuda(
        x["psi"], x["scan"], x["prb"], x["far"]), "scan"),
    "ls_objectives": (lambda x: linesearch._ls_objectives_cuda(
        x["far"], x["fd"], x["data"], x["gammas"], "gaussian"), "fd"),
    "gather_probe_mul": (lambda x: kernels._gather_probe_mul_cuda(
        x["psi"], x["scan"], x["prb"]), "scan"),
    "scatter_conj_probe": (lambda x: kernels._scatter_conj_probe_cuda(
        x["near"], x["scan"], x["prb"], 16, 16), "scan"),
    "adj_probe_reduce": (lambda x: kernels._adj_probe_reduce_cuda(
        x["near"], x["scan"], x["psi"]), "scan"),
    "lbfgs_gram": (lambda x: lbfgs._lbfgs_gram_cuda(
        x["S"], x["Y"], x["g"], x["gp"], x["dp"], 0.5, None), "Y"),
    "lbfgs_combine": (lambda x: lbfgs._lbfgs_combine_cuda(
        x["S"], x["Y"], x["g"], x["gp"], x["dp"], 0.5, 0, 1.0, [0.0, 0.0],
        [0.0, 0.0]), "Y"),
}


def _counters():
    """Every kernel counter of the four wrapper modules."""
    out = {"body": (fused.grad_fused.body,
                    dict(fused.grad_fused.body_launches))}
    for mod in (fused, kernels, linesearch, lbfgs):
        for key, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "launches"):
                out[mod.__name__, key] = (fn.launches,
                                          getattr(fn, "variant", None))
    return out


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_checks_its_inputs_before_loading_a_library(name,
                                                            monkeypatch):
    """Each of the 14 kernel wrappers refuses inputs of a wrong dtype, or
    on two devices, before any library is loaded, and counts nothing."""
    def load(*args, **kw):
        raise AssertionError(f"{name} loaded a library: {args}")

    monkeypatch.setattr(cuda_build, "load", load)
    _launch.lib.cache_clear()
    call, other = _WRAPPERS[name]
    before = _counters()
    with pytest.raises(TypeError, match=f"{name}: the CUDA kernel"):
        call(_wrapper_inputs(torch.float64))
    inputs = _wrapper_inputs(torch.complex64)
    inputs[other] = inputs[other].to("meta")
    with pytest.raises(ValueError, match=f"{name}: {other}.* is on meta"):
        call(inputs)
    assert _counters() == before


def test_options_fields_follow_the_reference_order():
    """The port's CGOptions fields are, in order, a subsequence of the JAX
    package's: a positional construction means the same in both."""
    import dataclasses

    from tikejax.solvers.cg import CGOptions as Reference
    from tikejax_torch.solvers.cg import CGOptions

    ref = [f.name for f in dataclasses.fields(Reference)]
    port = [f.name for f in dataclasses.fields(CGOptions)]
    assert [name for name in ref if name in port] == port
    assert port[2] == "recover_prb" and port[6] == "nchunks"
    positional = CGOptions(8, "poisson", True, 0.5, 0.25, 4, 2, "xla")
    reference = Reference(8, "poisson", True, 0.5, 0.25, 4, 2, "xla")
    for name in port[:8]:
        assert getattr(positional, name) == getattr(reference, name), name


def test_cuda_sources_are_package_data(monkeypatch, tmp_path):
    """Every kernel source and the shared header are found through
    importlib.resources, are named as package data, and a change to the
    header changes every kernel's library key."""
    import tomllib
    from importlib import resources

    csrc = resources.files("tikejax_torch") / "csrc"
    for name in cuda_build.KERNELS:
        assert (csrc / f"{name}.cu").is_file(), name
    assert (csrc / "dft_frame.cuh").is_file()
    meta = tomllib.loads((PKG.parent / "pyproject.toml").read_text())
    patterns = meta["tool"]["setuptools"]["package-data"]["tikejax_torch"]
    assert set(patterns) == {"csrc/*.cu", "csrc/*.cuh"}
    shipped = {p.name for pat in patterns for p in PKG.glob(pat)}
    assert shipped == {p.name for p in (PKG / "csrc").iterdir()}
    copy = tmp_path / "csrc"
    copy.mkdir()
    for path in (PKG / "csrc").iterdir():
        (copy / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", copy)
    before = {k: cuda_build.library_key(k) for k in cuda_build.KERNELS}
    assert before == {k: cuda_build.library_key(k) for k in cuda_build.KERNELS}
    with open(copy / "dft_frame.cuh", "a") as f:
        f.write("// edited\n")
    after = {k: cuda_build.library_key(k) for k in cuda_build.KERNELS}
    assert all(before[k] != after[k] for k in cuda_build.KERNELS)


def test_build_directory_is_the_checkout_or_a_user_cache(monkeypatch,
                                                         tmp_path):
    """build/kernels under the directory that holds the package while that
    can be written; a per-user cache directory otherwise."""
    assert cuda_build.BUILD_DIR == cuda_build.default_build_dir()
    assert cuda_build.default_build_dir(tmp_path) == (
        tmp_path / "build" / "kernels")
    monkeypatch.setattr(cuda_build.os, "access", lambda path, mode: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert cuda_build.default_build_dir(tmp_path) == (
        tmp_path / "cache" / "tikejax_torch" / "kernels")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cuda_build.default_build_dir(tmp_path) == (
        tmp_path / "home" / ".cache" / "tikejax_torch" / "kernels")


def test_library_key_covers_the_build_macros():
    """A source built with other -D macros is another library."""
    plain = cuda_build.library_key("adj_probe")
    assert cuda_build.library_key("adj_probe", ()) == plain
    assert cuda_build.library_key("adj_probe", ("TK_TEST=1",)) != plain


def test_kernel_reports_reads_the_compiler_output():
    report = """
ptxas info    : Compiling entry function '_Z3fooILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi128EEvv
    24 bytes stack frame, 48 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 24 bytes cumulative stack size, 18560 bytes smem
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""
    assert cuda_build.kernel_reports(report) == {
        "_Z3fooILi128EEvv": dict(registers=128, spill_stores=48,
                                 spill_loads=52, stack=24, smem=18560),
        "_Z3barv": dict(registers=64, spill_stores=0, spill_loads=0,
                        stack=0, smem=0)}
