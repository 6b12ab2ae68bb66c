"""Plain far-field ptychography in PyTorch: the benchmark's reference.

The forward model, its two adjoints, the two likelihoods and the two
illumination preconditioners, written from their definitions with no
kernel, no cache and nothing of the program under test: ``fwd`` gathers
each probe-sized object patch at a scan corner (floored), multiplies it by
every probe mode, zero-pads it to the detector frame and takes the unitary
2-D FFT; ``adj`` and ``adj_probe`` are its exact adjoints (unitary inverse
FFT, crop, conjugate multiply, sum into the object or over positions).

Everything runs over blocks of positions, so that no frame-sized array of
the whole scan is ever held (the data alone are 1 GiB at 16,384 frames of
128^2). ``precision`` is ``'fp64'`` (complex128 arithmetic: the yardstick),
``'fp32'`` (complex64: how the benchmark simulates its data) or ``'bf16'``
(every stored array -- object, probe, data, frames, residual and
gradients -- rounded to bfloat16, the arithmetic between in float32: the
control, one precision below the float32 the configurations state).
"""

from __future__ import annotations

import math

import torch

GAUSSIAN_EPS = 1e-12  # under the square root of the intensity
POISSON_EPS = 1e-8  # inside the logarithm and the residual's quotient
PRECISIONS = ("fp64", "fp32", "bf16")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, kept in float32 / complex64."""
    if x.is_complex():
        r = torch.view_as_real(x.to(torch.complex64))
        return torch.view_as_complex(
            r.to(torch.bfloat16).float().contiguous())
    return x.float().to(torch.bfloat16).float()


class Ptycho:
    """The operators of one scan, in one precision.

    ``scan`` is ``(ntheta, nscan, 2)`` float (y, x) top-left corners;
    ``block`` is the number of positions a block holds."""

    def __init__(self, scan: torch.Tensor, nz: int, n: int, nprb: int,
                 ndet: int, precision: str = "fp64", block: int = 1024):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.corners = torch.floor(scan.double()).to(torch.int64)
        c = self.corners
        if (c < 0).any() or (c[..., 0] > nz - nprb).any() or (
                c[..., 1] > n - nprb).any():
            raise ValueError("a scan corner lies outside the object")
        self.nz, self.n, self.nprb, self.ndet = nz, n, nprb, ndet
        self.ntheta, self.nscan = scan.shape[:2]
        self.precision = precision
        self.cdtype = (torch.complex128 if precision == "fp64"
                       else torch.complex64)
        self.rdtype = (torch.float64 if precision == "fp64"
                       else torch.float32)
        self.block = block
        r = torch.arange(nprb, device=scan.device)
        self._rows = r[:, None]
        self._cols = r[None, :]

    # -- precision ----------------------------------------------------------

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as this precision stores it."""
        if self.precision == "bf16":
            return _bf16(x)
        return x.to(self.cdtype if x.is_complex() else self.rdtype)

    def blocks(self):
        for a in range(0, self.nscan, self.block):
            yield slice(a, min(a + self.block, self.nscan))

    # -- the forward model and its adjoints ----------------------------------

    def _index(self, sl: slice) -> torch.Tensor:
        """``(ntheta, b, nprb, nprb)`` offsets into the flattened object."""
        c = self.corners[:, sl]
        t = torch.arange(self.ntheta, device=c.device)[:, None, None, None]
        iy = c[..., 0, None, None] + self._rows
        ix = c[..., 1, None, None] + self._cols
        return (t * self.nz + iy) * self.n + ix

    def patches(self, psi: torch.Tensor, sl: slice) -> torch.Tensor:
        return psi.reshape(-1)[self._index(sl)]

    def fwd(self, psi: torch.Tensor, prb: torch.Tensor,
            sl: slice) -> torch.Tensor:
        """Farplane of the block: ``(ntheta, b, nmodes, ndet, ndet)``."""
        near = self.store(self.patches(psi, sl)[:, :, None] * prb[:, None])
        pad = self.ndet - self.nprb
        near = torch.nn.functional.pad(near, (0, pad, 0, pad))
        return self.store(torch.fft.fft2(near, norm="ortho"))

    def _near(self, far: torch.Tensor) -> torch.Tensor:
        near = torch.fft.ifft2(far, norm="ortho")
        return self.store(near[..., :self.nprb, :self.nprb])

    def adj(self, far: torch.Tensor, prb: torch.Tensor, sl: slice,
            out: torch.Tensor) -> None:
        """Add the block's object adjoint into ``out`` ``(ntheta, nz, n)``."""
        patch = torch.sum(torch.conj(prb)[:, None] * self._near(far), dim=2)
        flat = torch.view_as_real(out).view(-1, 2)
        flat.index_add_(0, self._index(sl).reshape(-1),
                        torch.view_as_real(patch.contiguous()).view(-1, 2))

    def adj_probe(self, far: torch.Tensor, psi: torch.Tensor,
                  sl: slice) -> torch.Tensor:
        """The block's probe adjoint: ``(ntheta, nmodes, nprb, nprb)``."""
        patch = torch.conj(self.patches(psi, sl))[:, :, None]
        return torch.sum(patch * self._near(far), dim=1)

    # -- likelihoods ---------------------------------------------------------

    def objective(self, far: torch.Tensor, data: torch.Tensor, model: str):
        """(objective of the block, residual factor ``dF/dconj(far)``)."""
        intensity = torch.sum(far.real**2 + far.imag**2, dim=2)
        d = torch.clamp_min(self.store(data), 0.0)
        if model == "gaussian":
            amp = torch.sqrt(intensity + GAUSSIAN_EPS)
            f = torch.sum((amp - torch.sqrt(d))**2)
            factor = 1.0 - torch.sqrt(d) / amp
        elif model == "poisson":
            f = torch.sum(intensity - d * torch.log(intensity + POISSON_EPS))
            factor = 1.0 - d / (intensity + POISSON_EPS)
        else:
            raise ValueError(f"unknown model {model!r}")
        return f, factor

    def evaluate(self, psi, prb, data, model, want_psi=False,
                 want_prb=False):
        """(objective as a Python float, object gradient or None, probe
        gradient or None) at ``(psi, prb)``: the gradients are the adjoints
        of the likelihood's residual, without the constant factor 2."""
        f = torch.zeros((), dtype=self.rdtype, device=psi.device)
        gpsi = torch.zeros_like(psi) if want_psi else None
        gprb = torch.zeros_like(prb) if want_prb else None
        for sl in self.blocks():
            far = self.fwd(psi, prb, sl)
            fb, factor = self.objective(far, data[:, sl], model)
            f = f + fb
            if not (want_psi or want_prb):
                continue
            r = self.store(far * factor[:, :, None])
            del far
            if want_psi:
                self.adj(r, prb, sl, gpsi)
            if want_prb:
                gprb = gprb + self.adj_probe(r, psi, sl)
        if gpsi is not None:
            gpsi = self.store(gpsi)
        if gprb is not None:
            gprb = self.store(gprb)
        return float(f), gpsi, gprb

    # -- what the residual is measured against -------------------------------

    def data_sums(self, data: torch.Tensor, model: str):
        """(sum of the data, the objective at a perfect fit): the relative
        residual is ``sqrt(max(F - perfect, 0) / sum)``."""
        total = torch.zeros((), dtype=torch.float64, device=data.device)
        perfect = torch.zeros_like(total)
        for sl in self.blocks():
            d = torch.clamp_min(self.store(data[:, sl]).double(), 0.0)
            total = total + d.sum()
            if model == "poisson":
                perfect = perfect + torch.sum(d - d * torch.log(
                    d + POISSON_EPS))
        return float(total), float(perfect)

    # -- the preconditioners -------------------------------------------------

    def illumination(self, prb: torch.Tensor) -> torch.Tensor:
        """Probe power summed over modes, added at every patch, floored at
        a tenth of each angle's maximum: ``(ntheta, nz, n)`` real."""
        power = torch.sum(prb.real**2 + prb.imag**2, dim=1)  # (t, p, p)
        out = torch.zeros((self.ntheta * self.nz * self.n,),
                          dtype=power.dtype, device=prb.device)
        for sl in self.blocks():
            idx = self._index(sl)
            out.index_add_(0, idx.reshape(-1),
                           power[:, None].expand(idx.shape).reshape(-1))
        out = out.view(self.ntheta, self.nz, self.n)
        top = torch.amax(out, dim=(-2, -1), keepdim=True)
        return torch.maximum(out, 0.1 * top)

    def seen(self, psi: torch.Tensor) -> torch.Tensor:
        """Object power each probe pixel sees, summed over the positions,
        floored at a tenth of each angle's maximum: ``(ntheta, nprb,
        nprb)``."""
        power = psi.real**2 + psi.imag**2
        out = torch.zeros((self.ntheta, self.nprb, self.nprb),
                          dtype=power.dtype, device=psi.device)
        for sl in self.blocks():
            out = out + torch.sum(power.reshape(-1)[self._index(sl)], dim=1)
        top = torch.amax(out, dim=(-2, -1), keepdim=True)
        return torch.maximum(out, 0.1 * top)


def intensities(psi: torch.Tensor, scan: torch.Tensor, prb: torch.Tensor,
                ndet: int, block: int = 4096) -> torch.Tensor:
    """Noise-free measured intensities ``sum_m |fwd(psi)|^2`` in float32:
    ``(ntheta, nscan, ndet, ndet)``."""
    t, s = scan.shape[:2]
    nz, n = psi.shape[-2:]
    op = Ptycho(scan, nz, n, prb.shape[-1], ndet, "fp32", block)
    out = torch.empty((t, s, ndet, ndet), dtype=torch.float32,
                      device=psi.device)
    for sl in op.blocks():
        far = op.fwd(psi, prb, sl)
        out[:, sl] = torch.sum(far.real**2 + far.imag**2, dim=2)
    return out


def rdot(a: torch.Tensor, b: torch.Tensor) -> float:
    """Real inner product ``Re sum(conj(a) b)`` as a Python float."""
    return float(torch.sum(a.real * b.real + a.imag * b.imag))


def relative_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max|a - b| / max|b|``."""
    return float((a - b).abs().max() / b.abs().max())


def aligned_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max|c a - b| / max|b|`` with the least-squares complex ``c``: the
    joint objective cannot tell ``(psi, prb)`` from ``(c psi, prb / c)``,
    so a recovered object or probe is judged up to that scale."""
    a = a.to(b.dtype)
    c = torch.vdot(a.reshape(-1), b.reshape(-1)) / torch.vdot(
        a.reshape(-1), a.reshape(-1))
    return relative_max(c * a, b)


def residual(f: float, total: float, perfect: float) -> float:
    """The relative residual of the objective ``f``."""
    return math.sqrt(max(f - perfect, 0.0) / total)
