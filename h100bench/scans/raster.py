"""A raster of positions with uniform jitter: the scan of ``BASELINE.json``'s
configurations.

About ``sqrt(nscan)`` rows of ``ceil(sqrt(nscan))`` positions spread evenly
over every corner the probe can take, each moved by a uniform offset in
``[-jitter, jitter)`` pixels on each axis and clipped into bounds.
"""

from __future__ import annotations

import math

import torch


def positions(generator: torch.Generator, config: dict,
              device) -> torch.Tensor:
    """``(ntheta, nscan, 2)`` float32 (y, x) top-left corners."""
    t, s = config["ntheta"], config["nscan"]
    side = math.ceil(math.sqrt(s))
    rows = math.ceil(s / side)
    max_y, max_x = config["nz"] - config["nprb"], config["n"] - config["nprb"]
    ys = torch.linspace(0, max_y, rows, dtype=torch.float64, device=device)
    xs = torch.linspace(0, max_x, side, dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([yy.reshape(-1), xx.reshape(-1)], -1)[:s]
    scan = grid[None].expand(t, s, 2)
    u = torch.rand(scan.shape, generator=generator, dtype=torch.float64,
                   device=device)
    scan = scan + config["scan"]["jitter"] * (2 * u - 1)
    hi = torch.tensor([max_y, max_x], dtype=scan.dtype, device=device)
    return torch.minimum(scan.clamp_min(0), hi).to(torch.float32)
