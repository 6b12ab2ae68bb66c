"""Forward models: likelihood objectives and synthetic data."""

from tikejax_torch.models.simulate import (make_object, make_probe,
                                           make_problem, raster_scan,
                                           simulate_intensities)

__all__ = [
    "make_object", "make_probe", "make_problem", "raster_scan",
    "simulate_intensities",
]
