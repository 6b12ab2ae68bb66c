"""Synthetic ptychography data generation.

Counterpart of ``tikejax.models.simulate``: a smooth random object, a
Gaussian-envelope probe, a jittered raster scan and noise-free (or
Poisson-noisy) intensities ``data = sum_m |fwd(psi)|^2``. Randomness comes
from an explicit ``torch.Generator`` (on the device the arrays are made
on), so the random arrays differ from the JAX package's; ``make_probe`` and
``raster_scan(jitter=0)`` are deterministic and match it. Every function
builds on the card (``device="cuda"``) unless the caller passes another
device; without a card that raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import math

import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.models.likelihoods import total_intensity
from tikejax_torch.ops.diffraction import fwd_raw


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty(0, dtype=dtype).real.dtype


def make_object(generator: torch.Generator, ntheta: int, nz: int, n: int,
                dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """Smooth synthetic complex object: low-pass-filtered random amplitude
    in [0.5, 1] and phase in [-pi/3, pi/3]."""
    real_dtype = _real_dtype(dtype)

    def smooth():
        rough = torch.rand((ntheta, nz, n), generator=generator,
                           dtype=real_dtype, device=device)
        fy = torch.fft.fftfreq(nz, dtype=real_dtype, device=device)[:, None]
        fx = torch.fft.fftfreq(n, dtype=real_dtype, device=device)[None, :]
        lp = torch.exp(-((fy**2 + fx**2) / (2 * 0.02**2)))
        s = torch.fft.ifft2(torch.fft.fft2(rough) * lp).real
        lo = s.amin(dim=(-2, -1), keepdim=True)
        hi = s.amax(dim=(-2, -1), keepdim=True)
        return (s - lo) / (hi - lo + 1e-12)

    amp = 0.5 + 0.5 * smooth()
    phase = (math.pi / 3) * (2 * smooth() - 1)
    return torch.polar(amp, phase).to(dtype)


def make_probe(ntheta: int, nmodes: int, nprb: int, dtype=torch.complex64,
               device="cuda") -> torch.Tensor:
    """Gaussian-envelope probe with quadratic phase; higher modes are the
    envelope modulated by Hermite-like polynomials (power decaying ~4x per
    mode). Returns ``(ntheta, nmodes, nprb, nprb)``."""
    real_dtype = _real_dtype(dtype)
    y = (torch.arange(nprb, dtype=real_dtype, device=device) - nprb / 2
         + 0.5) / (nprb / 4)
    yy, xx = torch.meshgrid(y, y, indexing="ij")
    r2 = yy**2 + xx**2
    env = torch.exp(-r2 / 2) * torch.exp(1j * 0.4 * r2)
    modes = []
    for m in range(nmodes):
        h = torch.ones_like(yy)
        for _ in range(m):
            h = h * (yy if m % 2 else xx)
        modes.append((2.0**-m) * h * env)
    prb = torch.stack(modes)[None].to(dtype)
    return prb.expand(ntheta, nmodes, nprb, nprb).contiguous()


def raster_scan(generator: torch.Generator | None, geometry: Geometry,
                jitter: float = 1.0, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Raster grid of ~sqrt(nscan) x sqrt(nscan) positions covering the
    object with uniform sub-step jitter in [-jitter, jitter), clipped in
    bounds. Returns ``(ntheta, nscan, 2)`` float (y, x) top-left corners;
    with ``jitter=0`` no generator is needed."""
    g = geometry
    side = math.ceil(math.sqrt(g.nscan))
    rows = math.ceil(g.nscan / side)  # every row survives the truncation
    max_y, max_x = g.nz - g.nprb, g.n - g.nprb
    ys = torch.linspace(0, max_y, rows, dtype=torch.float64, device=device)
    xs = torch.linspace(0, max_x, side, dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([yy.reshape(-1), xx.reshape(-1)], -1)[:g.nscan]
    scan = grid[None].expand(g.ntheta, g.nscan, 2)
    if jitter:
        u = torch.rand(scan.shape, generator=generator, dtype=torch.float64,
                       device=device)
        scan = scan + jitter * (2 * u - 1)
    hi = torch.tensor([max_y, max_x], dtype=scan.dtype, device=device)
    return torch.minimum(scan.clamp_min(0), hi).to(dtype)


def simulate_intensities(psi: torch.Tensor, scan: torch.Tensor,
                         prb: torch.Tensor, ndet: int) -> torch.Tensor:
    """Noise-free measured intensities: sum over modes of |fwd|^2, with the
    'xla' oracle forward (the most accurate operator: simulation runs once,
    and the data must not inherit a fast tier's error).

    Chunked over scan positions so the mode-resolved farplane transient
    stays near 1 GiB. Returns ``(ntheta, nscan, ndet, ndet)``."""
    t, s = scan.shape[:2]
    nmodes = prb.shape[1]
    farplane_bytes = t * s * nmodes * ndet * ndet * psi.element_size()
    budget = 1024**3
    nch = 1
    if farplane_bytes > budget:
        want = -(-farplane_bytes // budget)
        # smallest divisor of s that is >= want (falls back to s)
        nch = next((c for c in range(want, s + 1) if s % c == 0), s)
    step = s // nch
    out = []
    for c in range(nch):
        far = fwd_raw(psi, scan[:, c * step:(c + 1) * step], prb, ndet,
                      kernel="xla")
        out.append(total_intensity(far))
        del far
    return torch.cat(out, dim=1)


def make_problem(generator: torch.Generator, geometry: Geometry,
                 dtype=torch.complex64, poisson_photons: float | None = None,
                 device="cuda"):
    """Build a full synthetic problem: (psi_true, scan, prb, data), all on
    ``device`` (the card by default; ``generator`` must belong to it).

    If ``poisson_photons`` is given, data is scaled so the mean frame sum is
    that many photons and Poisson shot noise is applied."""
    g = geometry
    psi = make_object(generator, g.ntheta, g.nz, g.n, dtype, device)
    prb = make_probe(g.ntheta, g.nmodes, g.nprb, dtype, device)
    scan = raster_scan(generator, g, device=device)
    data = simulate_intensities(psi, scan, prb, g.ndet)
    if poisson_photons is not None:
        per_frame = torch.mean(torch.sum(data, dim=(-2, -1)))
        scale = poisson_photons / per_frame
        data = torch.poisson(data * scale, generator=generator) / scale
    return psi, scan, prb, data
