"""Host-side scan-grid diagnostics (native-accelerated).

Counterpart of ``tikejax.models.diagnostics``. Ingestion checks for measured
datasets: out-of-bounds scan positions (the device kernels skip them
silently, which would corrupt the fit) and probe-coverage statistics
(uncovered object pixels are unconstrained and poison preconditioning).
Backed by the C++ scanprep library through ctypes (``tikejax_torch.native``)
with numpy fallbacks, because these run on the host at ingestion time --
before anything touches the device.
"""

from __future__ import annotations

import numpy as np

from tikejax_torch.geometry import Geometry
from tikejax_torch.native import scanprep


def scan_report(scan, geometry: Geometry) -> dict:
    """Validate a scan grid and report probe-coverage statistics.

    Args:
      scan: host array ``(ntheta, nscan, 2)`` float (y, x) corners.
      geometry: problem geometry.

    Returns:
      dict with ``n_out_of_bounds`` (positions whose probe window leaves
      the object), ``coverage_min``/``coverage_mean``/``coverage_max``
      (per-pixel probe-overlap counts over the covered pixels of the
      object, aggregated over angles), and ``uncovered_fraction`` (fraction
      of object pixels no probe ever touches).
    """
    g = geometry
    scan = np.asarray(scan, np.float32)
    if scan.shape != g.scan_shape:
        raise ValueError(f"scan shape {scan.shape} != {g.scan_shape}")
    scan_int, n_bad = scanprep.validate_scan(scan, g.nz, g.n, g.nprb)
    counts = np.zeros((g.nz, g.n), np.float64)
    for t in range(g.ntheta):
        counts += scanprep.overlap_counts_host(scan_int[t], g.nz, g.n,
                                               g.nprb)
    covered = counts > 0
    return {
        "n_out_of_bounds": int(n_bad),
        "coverage_min": float(counts[covered].min()) if covered.any()
        else 0.0,
        "coverage_mean": float(counts[covered].mean()) if covered.any()
        else 0.0,
        "coverage_max": float(counts.max()),
        "uncovered_fraction": float(1.0 - covered.mean()),
    }


def check_scan(scan, geometry: Geometry) -> None:
    """Raise ValueError if any scan position's probe window leaves the
    object (the strict form of :func:`scan_report` for ingestion paths)."""
    scan = np.asarray(scan, np.float32)
    _, n_bad = scanprep.validate_scan(scan, geometry.nz, geometry.n,
                                      geometry.nprb)
    if n_bad:
        raise ValueError(
            f"{n_bad} scan position(s) out of bounds: probe windows must "
            f"satisfy 0 <= y <= {geometry.nz - geometry.nprb}, "
            f"0 <= x <= {geometry.n - geometry.nprb}")
