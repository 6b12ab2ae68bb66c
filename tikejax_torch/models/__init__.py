"""Forward models: likelihood objectives, synthetic data, quality metrics
and host-side scan diagnostics."""

from tikejax_torch.models.diagnostics import check_scan, scan_report
from tikejax_torch.models.quality import (relative_object_error,
                                          relative_probe_error)
from tikejax_torch.models.simulate import (make_object, make_probe,
                                           make_problem, raster_scan,
                                           simulate_intensities)

__all__ = [
    "make_object", "make_probe", "make_problem", "raster_scan",
    "simulate_intensities", "relative_object_error", "relative_probe_error",
    "check_scan", "scan_report",
]
