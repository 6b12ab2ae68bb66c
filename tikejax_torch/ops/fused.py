"""Frameless likelihood gradient: the hand-written ``grad_fused`` kernel.

Counterpart of ``tikejax.ops.pallas_fused`` for the one kernel the main
path runs. It replaces ``tikejax/ops/pallas_fused.py`` ``grad_fused`` (the
TPU kernel ``_grad_kernel``): for every (angle, position, mode) frame it
gathers the object patch, multiplies by the probe, takes the unitary DFT of
the zero-padded frame, forms the likelihood factor and objective against
the measured frame, takes the inverse DFT, multiplies by the conj probe,
sums the modes and scatter-adds into the object gradient. It returns
``(grad (t, nz, n), minf ())`` with ``grad = G^H(factor * G psi)`` -- no
factor 2: the solver supplies it. No farplane or nearplane is ever
allocated, which is why the kernel exists: at 16384 positions of 128^2 the
farplane alone would be 2.1 GB.

The CUDA source is ``tikejax_torch/csrc/grad_fused.cu`` (built by
``tikejax_torch.utils.cuda_build``). What bounds it on an H100: the DFT is
computed as four complex matrix products per frame and mode,
``ndet*nprb*(nprb+ndet)`` complex multiply-adds per DFT application, twice
per frame -- 1.1e12 fp32 FLOPs per evaluation at 16384 frames of 128^2, all
on the SIMT fp32 units. The kernel keeps them in shared-memory tiled GEMMs
and keeps each frame's intermediates in per-block scratch sized by the
grid (never by the number of positions).

Precision tiers: the JAX package runs ``fused_mx``'s forward at bf16x3
Karatsuba (~8e-6) and its adjoint at single-pass bf16 (~2.5e-3). This
kernel computes both halves with plain fp32 multiply-adds, which meets or
beats every tier's accuracy, so every ``fused*`` tier maps to it and the
``precision``/``adj_precision`` tags are accepted and ignored.

Determinism: the gradient scatter uses fp32 atomics, deterministic up to
summation order; the objective is summed in double in a fixed order and
is bitwise reproducible.

``grad_fused`` takes CPU or CUDA tensors. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs :func:`grad_fused_reference`,
the plain PyTorch version built from the oracle operators. Each keeps an
integer count of its runs in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tikejax_torch.models import likelihoods
from tikejax_torch.ops import diffraction
from tikejax_torch.utils import cuda_build

_MODEL_CODE = {"gaussian": 0, "poisson": 1}
# The kernel's twiddle table lives in shared memory beside its tiles.
_MAX_NDET = 2048
# Per-block scratch holds one frame's intermediates; the grid is cut so
# that all of it stays below this many bytes.
_SCRATCH_BYTES = 256 * 1024**2

_BASE_NOT_PORTED = (
    "grad_fused(base=...): the split-operator epilogue is not ported yet; "
    "it arrives with solvers.reconstruct (ROADMAP.md, queue 2)")


def grad_fused(psi: torch.Tensor, data: torch.Tensor,
               scan_int: torch.Tensor, prb: torch.Tensor, ndet: int,
               model: str, precision=None, adj_precision=None, base=None):
    """Likelihood gradient w.r.t. the object plus the objective in one
    pass, without a farplane in memory.

    Args:
      psi: ``(ntheta, nz, n)`` complex object.
      data: ``(ntheta, nscan, ndet, ndet)`` real measured intensities.
      scan_int: ``(ntheta, nscan, 2)`` int32 (y, x) offsets; a row < 0
        marks a masked dummy position.
      prb: ``(ntheta, nmodes, nprb, nprb)`` complex probe.
      model: 'gaussian' or 'poisson'.
      precision, adj_precision: the JAX package's tier tags; ignored.

    Returns:
      (grad ``(ntheta, nz, n)`` like ``psi``, minf ``()`` real).
    """
    if base is not None:
        raise NotImplementedError(_BASE_NOT_PORTED)
    if model not in _MODEL_CODE:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{tuple(_MODEL_CODE)}")
    if psi.device.type == "cpu":
        return grad_fused_reference(psi, data, scan_int, prb, ndet, model)
    if psi.device.type != "cuda":
        raise ValueError(f"grad_fused takes CPU or CUDA tensors, got "
                         f"{psi.device}")
    return _grad_fused_cuda(psi, data, scan_int, prb, ndet, model)


grad_fused.launches = 0


def grad_fused_reference(psi: torch.Tensor, data: torch.Tensor,
                         scan_int: torch.Tensor, prb: torch.Tensor,
                         ndet: int, model: str, precision=None,
                         adj_precision=None):
    """Plain PyTorch version of :func:`grad_fused`, on any device: oracle
    forward, likelihood residual, oracle adjoint. The objective skips
    masked positions (scan row < 0), as the kernel does."""
    grad_fused_reference.launches += 1
    minf_fn, resid_fn = likelihoods.get_model(model)
    nz, n = psi.shape[-2:]
    far = diffraction.fwd_raw(psi, scan_int, prb, ndet, kernel="xla")
    grad = diffraction.adj_raw(resid_fn(far, data), scan_int, prb, nz, n,
                               kernel="xla")
    valid = scan_int[..., 0] >= 0
    if not bool(valid.all()):
        far, data = far[valid][None], data[valid][None]
    return grad, minf_fn(far, data)


grad_fused_reference.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("grad_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tk_grad_fused.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
    lib.tk_grad_fused.restype = i32
    lib.tk_grad_fused_blocks_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
    lib.tk_grad_fused_blocks_per_sm.restype = i32
    lib.tk_error_string.argtypes = [i32]
    lib.tk_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"grad_fused: {what} failed: "
                           f"{lib.tk_error_string(err).decode()}")


@functools.cache
def _resident_blocks(device_index: int, ndet: int) -> int:
    """Blocks the whole card holds at once at detector side ``ndet``."""
    lib = _lib()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _check(lib, lib.tk_grad_fused_blocks_per_sm(ndet,
                                                   ctypes.byref(per_sm)),
               "occupancy query")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return max(1, per_sm.value) * sms


def _grad_fused_cuda(psi, data, scan_int, prb, ndet, model):
    t, nz, n = psi.shape
    _, nmodes, nprb, _ = prb.shape
    s = scan_int.shape[1]
    expect = {"psi": (psi, torch.complex64), "prb": (prb, torch.complex64),
              "data": (data, torch.float32),
              "scan_int": (scan_int, torch.int32)}
    for name, (x, dtype) in expect.items():
        if x.device != psi.device:
            raise ValueError(f"grad_fused: {name} is on {x.device}, psi on "
                             f"{psi.device}")
        if x.dtype != dtype:
            raise TypeError(f"grad_fused: the CUDA kernel takes {name} as "
                            f"{dtype}, got {x.dtype}")
    if (prb.shape[0] != t or data.shape != (t, s, ndet, ndet)
            or scan_int.shape != (t, s, 2) or prb.shape[-1] != nprb):
        raise ValueError(
            f"grad_fused: inconsistent shapes psi {tuple(psi.shape)}, prb "
            f"{tuple(prb.shape)}, data {tuple(data.shape)}, scan_int "
            f"{tuple(scan_int.shape)}, ndet {ndet}")
    if not nprb <= ndet <= _MAX_NDET:
        raise ValueError(f"grad_fused: need nprb <= ndet <= {_MAX_NDET}, "
                         f"got nprb={nprb}, ndet={ndet}")
    lib = _lib()
    dev = psi.device.index if psi.device.index is not None else (
        torch.cuda.current_device())
    per_block = nmodes * ndet * (nprb + ndet)  # complex elements
    grid = min(t * s, _resident_blocks(dev, ndet),
               max(1, _SCRATCH_BYTES // (8 * per_block)))
    psi, prb = psi.contiguous(), prb.contiguous()
    data, scan_int = data.contiguous(), scan_int.contiguous()
    grad = torch.zeros((t, nz, n), dtype=torch.complex64, device=psi.device)
    scratch = torch.empty(2 * grid * per_block, dtype=torch.float32,
                          device=psi.device)
    partial = torch.empty(grid, dtype=torch.float64, device=psi.device)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tk_grad_fused(
            psi.data_ptr(), prb.data_ptr(), data.data_ptr(),
            scan_int.data_ptr(), grad.data_ptr(), scratch.data_ptr(),
            partial.data_ptr(), t, s, nz, n, nmodes, nprb, ndet,
            _MODEL_CODE[model], grid, stream)
    _check(lib, err, "kernel launch")
    grad_fused.launches += 1
    return grad, partial.sum().to(torch.float32)
