"""Jobs that a ``RankPool`` hands every rank: the sharded entry points on a
problem given as numpy arrays, on a CPU mesh.

Each job builds the mesh (``make_mesh(mesh_shape, device_type='cpu')``),
runs one entry point on the CPU tensors of the arrays and returns what it
returned, with the collectives this rank made (``cg.all_reduce``) and the
modules it has loaded that belong to jax. They live in the package so that a
rank imports this module, never the caller's: a rank needs no jax. The
port's sharding tests run them; so can anyone holding the port to another
implementation.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def _tensors(arrays):
    return {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                else v) for k, v in arrays.items()}


def _jax_modules():
    return sorted(k for k in sys.modules
                  if (k == "jax" or k.startswith(("jax.", "tikejax.")))
                  and sys.modules[k] is not None)


def sharded(rank: int, world: int, what: str, mesh_shape, geometry,
            arrays: dict, kw: dict):
    """Run the entry point ``what`` on this rank:

    * ``'run_sharded'``: ``run_sharded(data, psi0, scan, prb, geometry,
      mesh, f_base=, cg_init=, **kw)`` (the optional arrays when given);
    * ``'two_segments'``: two ``run_sharded`` runs, the second continuing
      from the first's ``metrics['cg_state']`` (``kw['piter']`` each);
    * ``'reconstruct'``: ``reconstruct(..., mesh=mesh, **kw)``;
    * ``'facade'``: ``compat.CGPtychoSolver(geometry fields, kernel=,
      device='cpu').run(data, psi0, scan, prb, mesh=mesh, **kw)``;
    * ``'fwd_sharded'``: ``fwd_sharded(psi0, shard_problem(...)[1], prb,
      geometry.ndet, kw['kernel'], mesh)`` after ``pad_scan_problem``.

    Returns {'out': the entry point's result, 'collectives': this rank's
    all-reduces, 'jax': the jax modules this rank loaded, 'rank': rank}.
    """
    from tikejax_torch import compat
    from tikejax_torch.parallel import sharding
    from tikejax_torch.solvers import cg, reconstruct

    a = _tensors(arrays)
    mesh = sharding.make_mesh(mesh_shape, device_type="cpu")
    before = cg.all_reduce.launches
    args = (a["data"], a["psi0"], a["scan"], a["prb"], geometry)
    if what == "run_sharded":
        out = sharding.run_sharded(*args, mesh, f_base=a.get("f_base"),
                                   cg_init=a.get("cg_init"), **kw)
    elif what == "two_segments":
        psi, _, m1 = sharding.run_sharded(*args, mesh, **kw)
        out = sharding.run_sharded(a["data"], psi, a["scan"], a["prb"],
                                   geometry, mesh, cg_init=m1["cg_state"],
                                   **kw)
    elif what == "reconstruct":
        out = reconstruct(*args, mesh=mesh, **kw)
    elif what == "facade":
        kw = dict(kw)
        solver = compat.CGPtychoSolver(
            geometry.ntheta, geometry.nz, geometry.n, geometry.nscan,
            geometry.ndet, geometry.nprb, geometry.nmodes,
            kernel=kw.pop("kernel", "auto"), device="cpu")
        out = solver.run(*(arrays[k] for k in ("data", "psi0", "scan",
                                                "prb")), mesh=mesh, **kw)
    elif what == "fwd_sharded":
        nsh = mesh.size(mesh.mesh_dim_names.index(sharding._axes(mesh)[1]))
        data, scan, _ = sharding.pad_scan_problem(a["data"], a["scan"],
                                                  geometry, nsh)
        _, scan_l = sharding.shard_problem(mesh, data, scan)
        out = (scan_l, sharding.fwd_sharded(a["psi0"], scan_l, a["prb"],
                                            geometry.ndet, kw["kernel"],
                                            mesh))
    else:
        raise ValueError(f"unknown job {what!r}")
    return {"out": out, "collectives": cg.all_reduce.launches - before,
            "jax": _jax_modules(), "rank": rank}


def errors(rank: int, world: int, mesh_shape, geometry, arrays: dict,
           cases: list):
    """Each case ``(entry, kw)`` that must fail: ``'run_sharded'`` with
    ``kw`` (``'mesh'`` in it replaces the mesh), ``'make_mesh'`` with
    ``kw['shape']``, ``'shard_problem'`` on the unpadded arrays, or
    ``'reconstruct'`` with ``kw``. Returns one (exception type, message)
    per case; ``(None, '')`` where a case did not raise."""
    from tikejax_torch.parallel import sharding
    from tikejax_torch.solvers import reconstruct

    a = _tensors(arrays)
    mesh = sharding.make_mesh(mesh_shape, device_type="cpu")
    args = (a["data"], a["psi0"], a["scan"], a["prb"], geometry)
    found = []
    for entry, kw in cases:
        kw = dict(kw)
        try:
            if entry == "run_sharded":
                m = kw.pop("mesh", mesh)
                fb = kw.pop("f_base", None)
                sharding.run_sharded(*args, m, f_base=(
                    None if fb is None else a[fb]), **kw)
            elif entry == "make_mesh":
                sharding.make_mesh(kw["shape"], device_type="cpu")
            elif entry == "shard_problem":
                sharding.shard_problem(mesh, a["data"], a["scan"])
            elif entry == "reconstruct":
                reconstruct(*args, **{"mesh": mesh, **kw})
            else:
                raise AssertionError(f"unknown entry {entry!r}")
            found.append((None, ""))
        except (ValueError, NotImplementedError, RuntimeError) as e:
            found.append((type(e).__name__, str(e)))
    return found


def stall(rank: int, world: int, seconds: float):
    """Rank 0 waits in an all-reduce that the other ranks join only after
    ``seconds``: a rank out of step, for the pool's time limit."""
    import torch.distributed as dist

    if rank:
        time.sleep(seconds)
    x = torch.ones(1)
    dist.all_reduce(x)
    return float(x)
