"""Data-fidelity objectives and their farplane-domain residuals.

Counterpart of ``tikejax.models.likelihoods``:

Gaussian (amplitude matching):
    F(G) = sum over frames of ( A - sqrt(d) )^2,
    with A = sqrt(sum_m |G_m|^2) the incoherent multi-mode amplitude.
    dF/dconj(G_m) = G_m * (1 - sqrt(d) / A).

Poisson (maximum likelihood for counting noise):
    F(G) = sum ( I - d * log(I + eps) ),   I = sum_m |G_m|^2
    dF/dconj(G_m) = G_m * (1 - d / (I + eps)).

The residual factor is shared across modes. Constant factors are absorbed
into the line search.
"""

from __future__ import annotations

import torch

MODELS = ("gaussian", "poisson")


def total_intensity(farplane: torch.Tensor) -> torch.Tensor:
    """Incoherent intensity: sum over the mode axis of |G_m|^2.

    farplane ``(ntheta, nscan, nmodes, ndet, ndet)`` ->
    ``(ntheta, nscan, ndet, ndet)`` real."""
    return torch.sum(farplane.real**2 + farplane.imag**2, dim=2)


def gaussian_minf(farplane, data, eps: float = 1e-12):
    amp = torch.sqrt(total_intensity(farplane) + eps)
    sq = torch.sqrt(torch.clamp_min(data, 0.0))
    return torch.sum((amp - sq)**2)


def gaussian_residual(farplane, data, eps: float = 1e-12):
    amp = torch.sqrt(total_intensity(farplane) + eps)
    sq = torch.sqrt(torch.clamp_min(data, 0.0))
    factor = 1.0 - sq / amp
    return farplane * factor[:, :, None].to(farplane.dtype)


def poisson_minf(farplane, data, eps: float = 1e-8):
    intensity = total_intensity(farplane)
    d = torch.clamp_min(data, 0.0)
    return torch.sum(intensity - d * torch.log(intensity + eps))


def poisson_perfect_minf(data, eps: float = 1e-8):
    """Poisson objective at the perfect fit ``I = d``: the data-dependent
    constant ``sum(d - d*log(d + eps))``. ``poisson_minf`` minus this is
    the generalized KL divergence, so the solver's Poisson ``residual``
    is ``sqrt(max(minf - this, 0) / sum(data))``."""
    d = torch.clamp_min(data, 0.0)
    return torch.sum(d - d * torch.log(d + eps))


def poisson_residual(farplane, data, eps: float = 1e-8):
    intensity = total_intensity(farplane)
    d = torch.clamp_min(data, 0.0)
    factor = 1.0 - d / (intensity + eps)
    return farplane * factor[:, :, None].to(farplane.dtype)


def get_model(model: str):
    """Return (minf, residual) functions for a likelihood model name."""
    if model == "gaussian":
        return gaussian_minf, gaussian_residual
    if model == "poisson":
        return poisson_minf, poisson_residual
    raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")
