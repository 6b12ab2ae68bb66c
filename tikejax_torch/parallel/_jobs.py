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
        except (ValueError, RuntimeError) as e:
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


def tiling_mesh(mesh_shape, device_type="cpu"):
    """The tiling mesh of ``mesh_shape``: ``(D,)`` an ``('obj',)`` mesh,
    ``(D, S)`` an ``('obj', 'scan')`` mesh, ``(T, D, S)`` a ``('theta',
    'obj', 'scan')`` mesh."""
    from tikejax_torch.parallel import tiling

    make = {1: tiling.make_obj_mesh, 2: tiling.make_obj_scan_mesh,
            3: tiling.make_full_mesh}[len(mesh_shape)]
    return make(*mesh_shape, device_type=device_type)


def tiled(rank: int, world: int, mesh_shape, geometry, arrays: dict,
          kw: dict):
    """``run_tiled(data, psi0, scan, prb, geometry, mesh, **kw)`` on this
    rank (:func:`tiling_mesh` of ``mesh_shape``). Returns {'out': its
    result, metrics without 'cg_state', 'collectives' and 'halo': this
    rank's all-reduces and halo broadcasts (with 'halo_bytes'), 'jax': the
    jax modules this rank loaded, 'rank': rank}."""
    from tikejax_torch.parallel import tiling
    from tikejax_torch.solvers import cg

    a = _tensors(arrays)
    mesh = tiling_mesh(mesh_shape)
    before = (cg.all_reduce.launches, cg.halo_exchange.launches,
              cg.halo_exchange.bytes)
    psi, prb, m = tiling.run_tiled(a["data"], a["psi0"], a["scan"], a["prb"],
                                   geometry, mesh, **kw)
    return {"out": (psi, prb, {k: v for k, v in m.items()
                               if k != "cg_state"}),
            "collectives": cg.all_reduce.launches - before[0],
            "halo": cg.halo_exchange.launches - before[1],
            "halo_bytes": cg.halo_exchange.bytes - before[2],
            "jax": _jax_modules(), "rank": rank}


def halo(rank: int, world: int, slabs, halo_rows: int):
    """``cg.halo_exchange`` of this rank's slab ``slabs[rank]`` on a
    ``('obj',)`` mesh of every rank: (the exchanged slab, the broadcasts
    and bytes this rank took part in)."""
    from tikejax_torch.solvers import cg

    mesh = tiling_mesh((world,))
    before = (cg.halo_exchange.launches, cg.halo_exchange.bytes)
    x = cg.halo_exchange(torch.from_numpy(np.array(slabs[rank])),
                         cg._halo_pairs(mesh, "obj"), halo_rows)
    return (x, cg.halo_exchange.launches - before[0],
            cg.halo_exchange.bytes - before[1])


def tiled_errors(rank: int, world: int, mesh_shape, geometry, arrays: dict,
                 cases: list):
    """Each case ``(entry, kw)`` that must fail: ``'run_tiled'`` with
    ``kw`` (``'mesh'`` in it replaces the mesh: ``'scan'`` a 1-D scan mesh
    of ``parallel.make_mesh``), ``'reconstruct'`` with ``kw`` (a mesh the
    same way), ``'mesh'`` with ``kw['shape']``. Returns one (exception
    type, message) per case; ``(None, '')`` where a case did not raise."""
    from tikejax_torch.parallel import sharding, tiling
    from tikejax_torch.solvers import reconstruct

    a = _tensors(arrays)
    args = (a["data"], a["psi0"], a["scan"], a["prb"], geometry)
    found = []
    for entry, kw in cases:
        kw = dict(kw)
        try:
            mesh = kw.pop("mesh", mesh_shape)
            mesh = (sharding.make_mesh(device_type="cpu") if mesh == "scan"
                    else tiling_mesh(mesh) if entry != "mesh" else None)
            if entry == "run_tiled":
                tiling.run_tiled(*args, mesh, **kw)
            elif entry == "reconstruct":
                reconstruct(*args, mesh=mesh, **kw)
            elif entry == "mesh":
                tiling_mesh(kw["shape"])
            else:
                raise AssertionError(f"unknown entry {entry!r}")
            found.append((None, ""))
        except (ValueError, RuntimeError) as e:
            found.append((type(e).__name__, str(e)))
    return found
