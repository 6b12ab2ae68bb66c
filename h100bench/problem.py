"""The benchmark's inputs: one problem a generator seed, made on the
device (a cell solves the pool its configuration names, ``pool_seeds``).

A plain copy of the synthetic problem of the program's own simulation (a
smooth random object with amplitude in [0.5, 1] and phase in [-pi/3,
pi/3], a Gaussian probe with a quadratic phase and Hermite-like higher
modes, a scan, and the noise-free intensities ``sum_m |fwd(psi)|^2``),
written against the reference operators so that nothing the program makes
enters its own inputs. One generator on the device, seeded once, draws
everything in a fixed order: the object, the scan, then the probe's
perturbation. The same inputs go to the program and to the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from pathlib import Path

import torch

from h100bench.reference.ptycho import intensities

HERE = Path(__file__).resolve().parent
GEOMETRY = ("nz", "n", "nscan", "ndet", "nprb", "ntheta", "nmodes")


@dataclasses.dataclass
class Problem:
    geometry: dict  # the GEOMETRY keys of the configuration
    model: str
    recover_prb: bool
    scan: torch.Tensor  # (ntheta, nscan, 2) float32
    data: torch.Tensor  # (ntheta, nscan, ndet, ndet) float32
    prb0: torch.Tensor  # (ntheta, nmodes, nprb, nprb) complex64
    psi0: torch.Tensor  # (ntheta, nz, n) complex64, ones


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer; taken
    modulo 2^64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    return gen


def make_object(gen: torch.Generator, t: int, nz: int, n: int,
                device) -> torch.Tensor:
    def smooth():
        rough = torch.rand((t, nz, n), generator=gen, device=device)
        fy = torch.fft.fftfreq(nz, device=device)[:, None]
        fx = torch.fft.fftfreq(n, device=device)[None, :]
        lp = torch.exp(-((fy**2 + fx**2) / (2 * 0.02**2)))
        s = torch.fft.ifft2(torch.fft.fft2(rough) * lp).real
        lo = s.amin(dim=(-2, -1), keepdim=True)
        hi = s.amax(dim=(-2, -1), keepdim=True)
        return (s - lo) / (hi - lo + 1e-12)

    amp = 0.5 + 0.5 * smooth()
    phase = (math.pi / 3) * (2 * smooth() - 1)
    return torch.polar(amp, phase).to(torch.complex64)


def make_probe(t: int, nmodes: int, nprb: int, device) -> torch.Tensor:
    y = (torch.arange(nprb, dtype=torch.float32, device=device) - nprb / 2
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
    prb = torch.stack(modes)[None].to(torch.complex64)
    return prb.expand(t, nmodes, nprb, nprb).contiguous()


def scan_kind(name: str):
    """The module ``scans/<name>.py``: its ``positions(generator, config,
    device)`` makes the scan."""
    if not (HERE / "scans" / f"{name}.py").is_file():
        raise ValueError(f"no scan pattern {name!r} in {HERE / 'scans'}")
    return importlib.import_module(f"h100bench.scans.{name}")


def make(config: dict, seed: int, device) -> Problem:
    """The configuration's problem for ``seed``, on ``device``."""
    geom = {k: config[k] for k in GEOMETRY}
    gen = generator(seed, device)
    t, m = geom["ntheta"], geom["nmodes"]
    psi_true = make_object(gen, t, geom["nz"], geom["n"], device)
    scan = scan_kind(config["scan"]["kind"]).positions(gen, config, device)
    prb = make_probe(t, m, geom["nprb"], device)
    data = intensities(psi_true, scan, prb, geom["ndet"])
    noise = config["probe_noise"]
    if noise:
        shape = prb.shape
        prb = prb + noise * prb.abs().max() * torch.complex(
            torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))
    psi0 = torch.ones((t, geom["nz"], geom["n"]), dtype=torch.complex64,
                      device=device)
    return Problem(geom, config["model"], config["recover_prb"], scan, data,
                   prb, psi0)
