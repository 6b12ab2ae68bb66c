"""Batched 2-D unitary FFTs for far-field propagation.

Counterpart of ``tikejax.ops.fft``: ``norm='ortho'`` makes the transform
unitary, so :func:`ifft2o` is the exact Hermitian adjoint of :func:`fft2o`.
The probe patch sits at the top-left corner of the detector frame.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fft2o(x: torch.Tensor) -> torch.Tensor:
    """Unitary 2-D FFT over the last two axes, batched over the rest."""
    return torch.fft.fft2(x, norm="ortho")


def ifft2o(x: torch.Tensor) -> torch.Tensor:
    """Unitary 2-D inverse FFT; Hermitian adjoint of :func:`fft2o`."""
    return torch.fft.ifft2(x, norm="ortho")


def pad_to_det(nearplane: torch.Tensor, ndet: int) -> torch.Tensor:
    """Zero-pad ``(..., nprb, nprb)`` frames to ``(..., ndet, ndet)`` with
    the patch in the top-left corner."""
    nprb = nearplane.shape[-1]
    if nprb == ndet:
        return nearplane
    return F.pad(nearplane, (0, ndet - nprb, 0, ndet - nprb))


def crop_from_det(frames: torch.Tensor, nprb: int) -> torch.Tensor:
    """Adjoint of :func:`pad_to_det`: crop the top-left ``nprb x nprb``."""
    if frames.shape[-1] == nprb:
        return frames
    return frames[..., :nprb, :nprb]
