"""Problem geometry for far-field ptychography (PyTorch port).

A copy of ``tikejax.geometry`` -- a pure dataclass -- so that this package
never imports ``tikejax`` (whose ``__init__`` pulls in jax). The layouts are
the JAX package's, so both packages take the same arrays:

==============  =============================================  =========
array           shape                                          dtype
==============  =============================================  =========
``psi``         ``(ntheta, nz, n)``                            complex
``scan``        ``(ntheta, nscan, 2)`` -- (y, x) top-left      float
                corner of each probe patch, in pixels
``prb``         ``(ntheta, nmodes, nprb, nprb)``               complex
``farplane``    ``(ntheta, nscan, nmodes, ndet, ndet)``        complex
``data``        ``(ntheta, nscan, ndet, ndet)``                real
==============  =============================================  =========
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static problem geometry.

    Attributes:
      nz: object grid height (pixels).
      n: object grid width (pixels).
      nscan: number of scan positions per angle.
      ndet: detector frame side (pixels).
      nprb: probe side (pixels); ``nprb <= ndet`` (zero-padded into the
        detector frame before the FFT, as in the reference fwd kernel).
      ntheta: number of projections/angles batched together (1 for plain
        ptychography; >1 for ptycho-tomography style batching).
      nmodes: number of incoherent probe modes.
    """

    nz: int
    n: int
    nscan: int
    ndet: int
    nprb: int
    ntheta: int = 1
    nmodes: int = 1

    def __post_init__(self) -> None:
        if self.nprb > self.ndet:
            raise ValueError(
                f"nprb ({self.nprb}) must be <= ndet ({self.ndet}); the probe "
                "patch is zero-padded into the detector frame")
        if self.nprb > min(self.nz, self.n):
            raise ValueError(
                f"nprb ({self.nprb}) must fit inside the object "
                f"({self.nz} x {self.n})")
        for name in ("nz", "n", "nscan", "ndet", "nprb", "ntheta", "nmodes"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @property
    def psi_shape(self) -> tuple[int, int, int]:
        return (self.ntheta, self.nz, self.n)

    @property
    def scan_shape(self) -> tuple[int, int, int]:
        return (self.ntheta, self.nscan, 2)

    @property
    def prb_shape(self) -> tuple[int, int, int, int]:
        return (self.ntheta, self.nmodes, self.nprb, self.nprb)

    @property
    def farplane_shape(self) -> tuple[int, int, int, int, int]:
        return (self.ntheta, self.nscan, self.nmodes, self.ndet, self.ndet)

    @property
    def data_shape(self) -> tuple[int, int, int, int]:
        return (self.ntheta, self.nscan, self.ndet, self.ndet)
