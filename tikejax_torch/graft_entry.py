"""The port's entry points: one gradient step on the card, and the
multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py`` (which is the JAX
package's and stays as it is):

* :func:`entry` returns one CG gradient evaluation of the Gaussian model,
  ``fwd_raw`` -> ``gaussian_minf`` / ``gaussian_residual`` -> ``adj_raw``,
  with example arguments: a 256^2 object, 256 positions, a 64^2 probe and
  detector, on the card by default (the operators' ``'auto'`` tier there is
  ``'fused_mp'``, the ``fwd`` and ``adj`` kernels; on the CPU it is the
  ``'xla'`` oracle);
* :func:`dryrun_multichip` runs ``tikejax_torch.parallel._dryrun.main(n)``
  -- one sharded CG step and, for an even ``n``, one object-tiled CG step
  on ``n`` gloo ranks on the CPU, each held against the one-process step --
  in a subprocess with a time limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.models import likelihoods, make_problem
from tikejax_torch.ops.diffraction import adj_raw, fwd_raw

ENTRY_GEOMETRY = Geometry(nz=256, n=256, nscan=256, ndet=64, nprb=64)


def entry(device="cuda"):
    """``(step, (psi, scan, prb, data))``: ``step(*args)`` returns the
    Gaussian objective and its object gradient ``(minf, grad)``."""
    g = ENTRY_GEOMETRY
    gen = torch.Generator(device=device).manual_seed(0)
    psi, scan, prb, data = make_problem(gen, g, device=device)

    def step(psi, scan, prb, data):
        """One CG gradient evaluation: minf and the object-space
        gradient."""
        farplane = fwd_raw(psi, scan, prb, g.ndet, kernel="auto")
        minf = likelihoods.gaussian_minf(farplane, data)
        resid = likelihoods.gaussian_residual(farplane, data)
        grad = adj_raw(resid, scan, prb, g.nz, g.n, kernel="auto")
        return minf, grad

    return step, (psi, scan, prb, data)


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> str:
    """Run the sharded and the tiled step on ``n_devices`` CPU ranks in a
    subprocess (``python -m tikejax_torch.parallel._dryrun n``); returns
    its report line, raises RuntimeError when it fails and
    ``TimeoutExpired`` past ``timeout`` seconds."""
    n = int(n_devices)
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "tikejax_torch.parallel._dryrun", str(n)],
        env=env, cwd=root, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"dryrun_multichip({n}) subprocess failed "
                           f"(rc={proc.returncode}); stderr tail above")
    return proc.stdout.strip().splitlines()[-1]
