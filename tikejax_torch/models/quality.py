"""Reconstruction-quality metrics.

Counterpart of ``tikejax.models.quality``. Ptychography reconstructs the
object and probe only up to inherent ambiguities -- at minimum a global
complex scale exchanged between psi and prb (psi/c, c*prb fits the data
identically). These metrics factor the ambiguities out before comparing
against ground truth, so tests and benchmarks can assert on real recovered
quality rather than raw norms.
"""

from __future__ import annotations

import numpy as np
import torch

from tikejax_torch.utils import bridge


def _host(x) -> np.ndarray:
    return bridge.to_numpy(x) if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _aligned_rel_error(a, b):
    """||c*a - b|| / ||b|| minimised over the complex scale c (the
    least-squares alignment c = <a, b> / <a, a>), in numpy on the host:
    the metrics are tiny."""
    a = _host(a).ravel()
    b = _host(b).ravel()
    c = np.vdot(a, b) / max(float(np.real(np.vdot(a, a))), 1e-32)
    return float(np.linalg.norm(c * a - b) / np.linalg.norm(b))


def relative_object_error(psi, psi_true, border_frac: float = 0.125):
    """Scale/phase-invariant relative object error on the illuminated
    interior (a ``border_frac`` margin is excluded: the object border is
    never touched by the probe, so it carries no information)."""
    m = max(1, int(psi.shape[-1] * border_frac))
    return _aligned_rel_error(psi[..., m:-m, m:-m], psi_true[..., m:-m, m:-m])


def relative_probe_error(prb, prb_true):
    """Scale/phase-invariant relative probe error.

    A single complex scale is fit across the whole (ntheta, nmodes, nprb,
    nprb) stack -- the exact inverse of the scale the object absorbs.
    (Degenerate multi-mode subspaces can additionally mix under a unitary;
    for the synthetic probes here mode powers decay ~4x per mode, so the
    scalar alignment is the right invariance.)
    """
    return _aligned_rel_error(prb, prb_true)
