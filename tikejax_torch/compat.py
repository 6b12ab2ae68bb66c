"""Reference-compatible solver facade.

Counterpart of ``tikejax.compat``: a drop-in-shaped equivalent of the
reference's solver class (``CGPtychoSolver`` over its cuFFT operator
object): the same constructor geometry arguments, the same ``fwd`` / ``adj``
/ ``adj_probe`` / ``run`` methods -- taking host numpy arrays (or tensors)
instead of raw GPU pointers and returning numpy arrays, with this package's
engine underneath. As in the JAX package, arrays are taken in as complex64
/ float32.

Arrays go to the card: the one argument the port adds is ``device`` (default
``'cuda'``; the CPU tests pass ``'cpu'``). There is no silent CPU fallback.

Array layouts (documented in ``tikejax_torch.geometry``): ``psi (ntheta, nz,
n)``, ``scan (ntheta, nscan, 2)`` float (y, x), ``prb (ntheta, nmodes, nprb,
nprb)`` (a mode-less ``(ntheta, nprb, nprb)`` probe is accepted when
nmodes == 1), ``data (ntheta, nscan, ndet, ndet)``.
"""

from __future__ import annotations

import numpy as np
import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops.diffraction import Ptycho
from tikejax_torch.solvers import cg as _cg
from tikejax_torch.utils import bridge


class CGPtychoSolver:
    """Conjugate-gradient ptychography solver, reference-shaped API."""

    def __init__(self, ntheta: int, nz: int, n: int, nscan: int, ndet: int,
                 nprb: int, nmodes: int = 1, kernel: str = "auto",
                 device: str | torch.device = "cuda"):
        self.geometry = Geometry(ntheta=ntheta, nz=nz, n=n, nscan=nscan,
                                 ndet=ndet, nprb=nprb, nmodes=nmodes)
        self.op = Ptycho(self.geometry, kernel=kernel)
        self.kernel = kernel
        self.device = torch.device(device)

    # -- array ingestion -------------------------------------------------

    def _to_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        return x.to(device=self.device, dtype=dtype)

    def _prb(self, prb):
        prb = self._to_device(prb, torch.complex64)
        if prb.ndim == 3:
            prb = prb[:, None]
        if prb.shape != self.geometry.prb_shape:
            raise ValueError(f"prb shape {tuple(prb.shape)} != "
                             f"{self.geometry.prb_shape}")
        return prb

    def _psi(self, psi):
        psi = self._to_device(psi, torch.complex64)
        if psi.shape != self.geometry.psi_shape:
            raise ValueError(f"psi shape {tuple(psi.shape)} != "
                             f"{self.geometry.psi_shape}")
        return psi

    def _scan(self, scan):
        if tuple(scan.shape) != self.geometry.scan_shape:
            raise ValueError(f"scan shape {tuple(scan.shape)} != "
                             f"{self.geometry.scan_shape}")
        if isinstance(scan, np.ndarray):
            # Host-side ingestion validation (native scanprep): the device
            # kernels skip out-of-bounds windows silently, which would
            # corrupt the fit -- reject bad grids at the boundary.
            from tikejax_torch.models import check_scan

            check_scan(scan, self.geometry)
        return self._to_device(scan, torch.float32)

    # -- operators -------------------------------------------------------

    def fwd(self, psi, scan, prb):
        """farplane = G(psi); (ntheta, nscan, nmodes, ndet, ndet) numpy."""
        out = self.op.fwd(self._psi(psi), self._scan(scan), self._prb(prb))
        return bridge.to_numpy(out)

    def adj(self, farplane, scan, prb):
        out = self.op.adj(self._to_device(farplane, torch.complex64),
                          self._scan(scan), self._prb(prb))
        return bridge.to_numpy(out)

    def adj_probe(self, farplane, scan, psi):
        out = self.op.adj_probe(self._to_device(farplane, torch.complex64),
                                self._scan(scan), self._psi(psi))
        return bridge.to_numpy(out)

    # -- solver ----------------------------------------------------------

    def run(self, data, psi, scan, prb, piter: int = 32,
            model: str = "gaussian", recover_prb: bool = False,
            mesh=None, **kw):
        """Reconstruct; mirrors the reference's ``run`` signature.

        With ``mesh`` (a ``DeviceMesh`` from
        ``tikejax_torch.parallel.make_mesh``: 1-D scan-position sharding or
        2-D ('theta', 'scan')) the run is sharded over the mesh through
        :func:`tikejax_torch.parallel.run_sharded`: every rank of the mesh
        calls this with the whole problem and gets the whole result.

        Returns a dict with numpy arrays: {'psi', 'prb', 'minf',
        'residual', 'gamma', 'grad_norm', 'gamma_prb', 'iters_run'} (the
        reference prints diagnostics and returns arrays; here the
        per-iteration metrics come back too), and this solver's counts
        'host_syncs' and 'evaluations'.
        """
        kw.setdefault("kernel", self.kernel)
        kw.update(piter=piter, model=model, recover_prb=recover_prb)
        args = (self._to_device(data, torch.float32), self._psi(psi),
                self._scan(scan), self._prb(prb), self.geometry)
        if mesh is not None:
            from tikejax_torch.parallel import run_sharded

            # run_sharded pads an uneven nscan and keeps this rank's slice.
            psi_r, prb_r, metrics = run_sharded(*args, mesh, **kw)
        else:
            psi_r, prb_r, metrics = _cg.run(*args, **kw)
        out = {"psi": bridge.to_numpy(psi_r), "prb": bridge.to_numpy(prb_r)}
        out.update(bridge.to_numpy_tree(metrics))
        return out

    def reconstruct(self, data, psi, scan, prb,
                    target_residual: float = 1e-6, **kw):
        """Deep-residual reconstruction to a target relative residual (the
        split-operator / tier-chaining solver,
        :func:`tikejax_torch.solvers.reconstruct`) through the
        reference-shaped facade. Extra keywords pass through, ``mesh=``
        included (every stage then runs sharded; every rank calls this).

        Returns a dict {'psi', 'prb', 'residual_last', 'iters_run',
        'stages'}: ``stages`` lists (stage_name, iterations) pairs.
        """
        from tikejax_torch.solvers import reconstruct as _reconstruct

        kw.setdefault("kernel", self.kernel)
        if kw.get("kernel") == "auto":
            del kw["kernel"]  # reconstruct chains tiers itself
        psi_r, prb_r, stages = _reconstruct(
            self._to_device(data, torch.float32), self._psi(psi),
            self._scan(scan), self._prb(prb), self.geometry,
            target_residual=target_residual, **kw)
        total = 0
        names = []
        res_last = None
        for name, m in stages:
            k = int(m["iters_run"])
            total += k
            names.append((name, k))
            if k > 0:
                res_last = float(m["residual"][k - 1])
        return {"psi": bridge.to_numpy(psi_r),
                "prb": bridge.to_numpy(prb_r),
                "residual_last": res_last,
                "iters_run": total,
                "stages": names}

