"""Far-field ptychography diffraction operators: fwd / adj / adj_probe.

Counterpart of ``tikejax.ops.diffraction``:

  fwd:        psi, scan, prb  ->  farplane
              gather object patches at scan offsets, multiply by each
              probe mode, zero-pad to the detector frame, unitary 2-D FFT.
  adj:        farplane, scan, prb  ->  psi-domain accumulation
              unitary inverse FFT, crop, conj(probe) multiply, sum over
              modes, overlap scatter-add into the object.
  adj_probe:  farplane, scan, psi  ->  probe-domain accumulation
              unitary inverse FFT, crop, conj(object patch) multiply,
              sum over scan positions per mode.

All three are C-linear maps and exact Hermitian adjoints of each other
under ``<a, b> = sum(conj(a) * b)``.

``kernel`` names the implementation as in the JAX package. Only the
``'xla'`` oracle path (gather -> probe multiply -> pad -> ``fft2o`` and its
adjoints, here in plain PyTorch) exists at the operator level: the fused
operator kernels (``fwd``, ``adj``, ``adj_probe``) are not ported yet, so
a ``'fused*'`` or ``'pallas'`` operator call raises NotImplementedError on
every device instead of rerouting to ``'xla'``. ``'auto'`` resolves as in
the JAX package, with "the tensor is on CUDA" in place of "the backend is
the TPU": the symmetric ``'fused_mp'`` tier for operators, the solver's
target-aware choice in :func:`resolve_kernel_for_target`. The solver's
gradient pass on the fused tiers runs the ported ``grad_fused`` kernel
(``tikejax_torch.ops.fused``).
"""

from __future__ import annotations

import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops import patches as _patches
from tikejax_torch.ops.fft import crop_from_det, fft2o, ifft2o, pad_to_det

_KERNELS = ("xla", "pallas", "fused", "fused_mp", "fused_hp", "fused_mx",
            "fused_hx", "fused_am", "auto")

# Residual floors of the fused tiers, as the JAX package defines them for
# its target-aware 'auto' resolution.
FUSED_RESIDUAL_FLOOR = 5e-3
FUSED_MP_RESIDUAL_FLOOR = 1e-5

_UNPORTED_OPERATOR = (
    "kernel={kernel!r}: the fused operator kernels (fwd/adj/adj_probe) and "
    "the hybrid 'pallas' kernels are not ported to CUDA yet (ROADMAP.md, "
    "queue 2); pass kernel='xla' for the oracle operators")


def _backend(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def resolve_kernel(kernel: str, backend: str | None = None) -> str:
    """Resolve 'auto' for OPERATOR-level use: the symmetric 'fused_mp'
    tier on CUDA, 'xla' elsewhere. ``backend`` is 'cuda' or 'cpu' (the
    device type of the tensors the operator is given)."""
    if kernel == "auto":
        return "fused_mp" if backend == "cuda" else "xla"
    return kernel


def resolve_kernel_for_target(kernel: str, target_residual: float,
                              backend: str | None = None) -> str:
    """The SOLVER's 'auto' resolution: on CUDA, a deep target escalates to
    'fused_hp', a shallow one (above the single-pass floor) picks
    'fused', everything else 'fused_mx'. Explicit kernels pass through.
    In this port every fused tier runs the same fp32 ``grad_fused``
    kernel (see ``tikejax_torch.ops.fused``)."""
    if kernel != "auto" or backend != "cuda":
        return resolve_kernel(kernel, backend)
    if target_residual and target_residual <= FUSED_MP_RESIDUAL_FLOOR:
        return "fused_hp"
    if target_residual and target_residual > FUSED_RESIDUAL_FLOOR:
        return "fused"
    return "fused_mx"


def _fused_precision(kernel: str):
    """The JAX package's forward-DFT precision tag of a fused tier. The
    port's kernel ignores it: it computes every tier in fp32."""
    if kernel in ("fused_hp", "fused_hx"):
        return "kara_hp"
    if kernel in ("fused_mp", "fused_mx"):
        return "kara_x3"
    return None


def _fused_adj_precision(kernel: str):
    """The JAX package's adjoint-IDFT precision tag of a fused tier
    ('bf16' for the asymmetric mx/hx tiers). Ignored by the port's
    kernel, as :func:`_fused_precision`."""
    if kernel in ("fused_mx", "fused_hx"):
        return "bf16"
    if kernel == "fused_am":
        return "kara_x3"
    return _fused_precision(kernel)


def _check_kernel(kernel: str) -> None:
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{_KERNELS}")


def _operator_kernel(kernel: str, x: torch.Tensor) -> str:
    _check_kernel(kernel)
    kernel = resolve_kernel(kernel, _backend(x.device))
    if kernel != "xla":
        raise NotImplementedError(_UNPORTED_OPERATOR.format(kernel=kernel))
    return kernel


def fwd_raw(psi: torch.Tensor, scan: torch.Tensor, prb: torch.Tensor,
            ndet: int, kernel: str = "xla") -> torch.Tensor:
    """Forward diffraction. Returns ``(ntheta, nscan, nmodes, ndet, ndet)``."""
    _operator_kernel(kernel, psi)
    scan_int = _patches.scan_to_int(scan)
    nprb = prb.shape[-1]
    patches = _patches.gather_patches(psi, scan_int, nprb)
    nearplane = patches[:, :, None] * prb[:, None]  # (t, s, m, p, p)
    return fft2o(pad_to_det(nearplane, ndet))


def adj_raw(farplane: torch.Tensor, scan: torch.Tensor, prb: torch.Tensor,
            nz: int, n: int, kernel: str = "xla") -> torch.Tensor:
    """Adjoint w.r.t. the object. Returns ``(ntheta, nz, n)``."""
    _operator_kernel(kernel, farplane)
    nprb = prb.shape[-1]
    scan_int = _patches.scan_to_int(scan)
    nearplane = crop_from_det(ifft2o(farplane), nprb)  # (t, s, m, p, p)
    patches = torch.sum(torch.conj(prb)[:, None] * nearplane, dim=2)
    return _patches.scatter_patches_add(patches, scan_int, nz, n)


def adj_probe_raw(farplane: torch.Tensor, scan: torch.Tensor,
                  psi: torch.Tensor, nprb: int,
                  kernel: str = "xla") -> torch.Tensor:
    """Adjoint w.r.t. the probe. Returns ``(ntheta, nmodes, nprb, nprb)``."""
    _operator_kernel(kernel, farplane)
    scan_int = _patches.scan_to_int(scan)
    nearplane = crop_from_det(ifft2o(farplane), nprb)  # (t, s, m, p, p)
    patches = _patches.gather_patches(psi, scan_int, nprb)
    return torch.sum(torch.conj(patches)[:, :, None] * nearplane, dim=1)


class _Fwd(torch.autograd.Function):
    """Forward diffraction whose backward is the hand adjoints.

    PyTorch's backward of a C-linear map ``y = A x`` receives ``dL/dy*``
    and returns ``A^H`` of it, so the adjoints are used as they are: the
    conjugations that the JAX package wraps around them exist only because
    JAX's vjp is the unconjugated transpose. ``scan`` gets no gradient."""

    @staticmethod
    def forward(ctx, psi, scan, prb, ndet, kernel):
        ctx.save_for_backward(psi, scan, prb)
        ctx.kernel = kernel
        return fwd_raw(psi, scan, prb, ndet, kernel)

    @staticmethod
    def backward(ctx, g):
        psi, scan, prb = ctx.saved_tensors
        nz, n = psi.shape[-2:]
        dpsi = dprb = None
        if ctx.needs_input_grad[0]:
            dpsi = adj_raw(g, scan, prb, nz, n, ctx.kernel)
        if ctx.needs_input_grad[2]:
            dprb = adj_probe_raw(g, scan, psi, prb.shape[-1], ctx.kernel)
        return dpsi, None, dprb, None, None


def fwd(psi: torch.Tensor, scan: torch.Tensor, prb: torch.Tensor, ndet: int,
        kernel: str = "xla") -> torch.Tensor:
    """Differentiable forward diffraction operator: autograd through this
    function uses :func:`adj_raw` and :func:`adj_probe_raw`."""
    return _Fwd.apply(psi, scan, prb, ndet, kernel)


class Ptycho:
    """Geometry-bound diffraction operator bundle.

    >>> op = Ptycho(Geometry(nz=256, n=256, nscan=100, ndet=64, nprb=64))
    >>> farplane = op.fwd(psi, scan, prb)
    """

    def __init__(self, geometry: Geometry, kernel: str = "auto"):
        _check_kernel(kernel)
        self.g = geometry
        self.kernel = kernel

    def fwd(self, psi, scan, prb):
        return fwd(psi, scan, prb, self.g.ndet, self.kernel)

    def adj(self, farplane, scan, prb):
        return adj_raw(farplane, scan, prb, self.g.nz, self.g.n, self.kernel)

    def adj_probe(self, farplane, scan, psi):
        return adj_probe_raw(farplane, scan, psi, self.g.nprb, self.kernel)
