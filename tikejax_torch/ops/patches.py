"""Patch gather / overlap scatter-add over scan positions (oracle path).

Counterpart of ``tikejax.ops.patches``. Scan positions are float (y, x)
top-left corners, floored to integer pixel offsets, and must be in bounds:
``0 <= y <= nz - nprb``, ``0 <= x <= n - nprb``.

A scan ROW < 0 is the sentinel for a masked dummy position: it contributes
exactly zero everywhere -- gathers return zero patches, scatters add
nothing and the illumination maps skip it.

The scatter here is ``index_add_``: deterministic on the CPU, atomic (and
so deterministic only up to summation order) on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch


def scan_to_int(scan: torch.Tensor) -> torch.Tensor:
    """Floor float (y, x) scan coordinates to int32 pixel offsets."""
    if not scan.is_floating_point():
        return scan.to(torch.int32)
    return torch.floor(scan).to(torch.int32)


def check_scan_in_bounds(scan, nz: int, n: int, nprb: int) -> None:
    """Host-side validation that all scan positions are in bounds."""
    if isinstance(scan, torch.Tensor):
        scan = scan.detach().cpu().numpy()
    s = np.floor(np.asarray(scan)).astype(np.int64)
    y, x = s[..., 0], s[..., 1]
    bad = (y < 0) | (x < 0) | (y > nz - nprb) | (x > n - nprb)
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} scan position(s) out of bounds for object "
            f"{nz}x{n} with probe {nprb}: y must be in [0, {nz - nprb}], "
            f"x in [0, {n - nprb}]")


def _valid(scan_int: torch.Tensor) -> torch.Tensor:
    return scan_int[..., 0] >= 0


def _flat_index(scan_int: torch.Tensor, nprb: int, nz: int,
                n: int) -> torch.Tensor:
    """``(ntheta, nscan, nprb, nprb)`` int64 offsets into the flattened
    ``(ntheta, nz, n)`` object; sentinel rows are clamped to row 0 (their
    patches are masked by the callers)."""
    ntheta = scan_int.shape[0]
    s = scan_int.clamp_min(0).to(torch.int64)
    r = torch.arange(nprb, device=s.device)
    iy = s[..., 0, None, None] + r[:, None]
    ix = s[..., 1, None, None] + r[None, :]
    t = torch.arange(ntheta, device=s.device)[:, None, None, None]
    return (t * nz + iy) * n + ix


def gather_patches(psi: torch.Tensor, scan_int: torch.Tensor,
                   nprb: int) -> torch.Tensor:
    """Gather ``nprb x nprb`` object patches at integer scan offsets.

    Returns ``(ntheta, nscan, nprb, nprb)`` patches, same dtype as ``psi``
    (zero for sentinel-masked positions)."""
    _, nz, n = psi.shape
    patches = psi.reshape(-1)[_flat_index(scan_int, nprb, nz, n)]
    valid = _valid(scan_int)[..., None, None]
    return torch.where(valid, patches, torch.zeros((), dtype=psi.dtype,
                                                   device=psi.device))


def scatter_patches_add(patches: torch.Tensor, scan_int: torch.Tensor,
                        nz: int, n: int) -> torch.Tensor:
    """Adjoint of :func:`gather_patches`: sum patches into a zero object.

    Returns ``(ntheta, nz, n)``."""
    ntheta, _, nprb, _ = patches.shape
    valid = _valid(scan_int)[..., None, None]
    patches = torch.where(valid, patches, torch.zeros(
        (), dtype=patches.dtype, device=patches.device))
    out = torch.zeros(ntheta * nz * n, dtype=patches.dtype,
                      device=patches.device)
    out.index_add_(0, _flat_index(scan_int, nprb, nz, n).reshape(-1),
                   patches.reshape(-1))
    return out.reshape(ntheta, nz, n)


def _delta_map(scan_int: torch.Tensor, h: int, w: int,
               dtype) -> torch.Tensor:
    """``(ntheta, h, w)`` map with one unit at every valid position's
    top-left corner (sentinel rows get zero weight)."""
    ntheta = scan_int.shape[0]
    s = scan_int.clamp_min(0).to(torch.int64)
    t = torch.arange(ntheta, device=s.device)[:, None].expand_as(s[..., 0])
    delta = torch.zeros((ntheta, h, w), dtype=dtype, device=s.device)
    delta.index_put_((t, s[..., 0], s[..., 1]),
                     _valid(scan_int).to(dtype), accumulate=True)
    return delta


def illumination_map(scan_int: torch.Tensor, kernel: torch.Tensor, nz: int,
                     n: int) -> torch.Tensor:
    """Sum of a fixed ``(ntheta, nprb, nprb)`` real kernel scattered at all
    scan offsets, as an FFT convolution of the position delta map with the
    kernel. Used as the object-gradient preconditioner denominator."""
    nprb = kernel.shape[-1]
    h, w = nz + nprb, n + nprb
    delta = _delta_map(scan_int, h, w, kernel.dtype)
    kpad = torch.nn.functional.pad(kernel, (0, w - nprb, 0, h - nprb))
    conv = torch.fft.irfft2(torch.fft.rfft2(delta) * torch.fft.rfft2(kpad),
                            s=(h, w))
    return conv[:, :nz, :n]


def overlap_counts(scan_int: torch.Tensor, nz: int, n: int, nprb: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Per-pixel patch coverage count: scatter of all-ones patches."""
    ntheta, nscan = scan_int.shape[:2]
    ones = torch.ones((ntheta, nscan, nprb, nprb), dtype=dtype,
                      device=scan_int.device)
    return scatter_patches_add(ones, scan_int, nz, n)
