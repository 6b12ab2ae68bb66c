"""Object tiling (P3) on ``torch.distributed``: the object's rows split
into slabs over a mesh dimension ``'obj'``, with a halo exchange.

Counterpart of ``tikejax.parallel.tiling``. When the object outgrows one
card, its ROW axis is cut into equal slabs, one per rank of the ``'obj'``
dimension. Each rank holds its owned rows plus ``nprb - 1`` halo rows below
them (the probe windows' overlap into the next slab) and the scan positions
whose window's TOP row falls in its slab; the whole object never exists on
one rank during the reconstruction. Each CG iteration's collectives are

* the halo exchange of every object gradient and of the illumination map:
  two ``(ntheta, nprb - 1, n)`` strips, the halo rows forward (added into
  the next slab's first rows) and the completed first rows back (the
  JAX package's ``_halo_fix``, ``solvers.cg.halo_exchange``), and
* the scalar all-reduces of the objective, the line search and the
  Dai-Yuan and L-BFGS inner products (the last over the owned rows only).

Positions may split UNEQUALLY over the slabs (a raster scan does under the
owner rule, a jittered one too): :func:`partition_problem` pads every
slab's list of positions to the largest with sentinel dummies (scan row -1,
zero data), which every kernel treats as adding exactly zero. An
``('obj', 'scan')`` mesh (:func:`make_obj_scan_mesh`) also shards each
slab's positions over the ranks of its scan group, and a ``('theta', 'obj',
'scan')`` mesh (:func:`make_full_mesh`) the angles too: the CG core sums
the object gradient over ``'scan'`` before the halo exchange over
``'obj'``, the probe gradient over both, the object-domain inner products
over ``'theta'`` and ``'obj'`` and the scalars over every rank.

Execution model, as in ``parallel.sharding``: every rank calls
:func:`run_tiled` with the global arrays and runs ``solvers.cg.run_impl`` on
its slab; the step control is on the host and every branch reads a reduced
value, so the ranks stay in lock step. The halo exchange is built from
broadcasts in two-rank groups ``{d, d + 1}`` along ``'obj'``, because gloo
takes CUDA tensors only for ``all_reduce`` and ``broadcast`` (no
point-to-point): one path on gloo and on NCCL alike. psi and prb come back
global on every rank: the owned rows of every slab (and every angle) are
written into a zero-filled global tensor and all-reduced, as
``sharding.gather_angles`` gathers angles. Restrictions, as in the JAX
package: the object rows must divide by the slab count, each slab must be
at least ``nprb - 1`` rows tall, ``nchunks`` must divide the padded count
of a rank's positions, and ``carry_state`` is refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops import diffraction
from tikejax_torch.parallel import sharding
from tikejax_torch.solvers import cg as _cg


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("the tiling meshes need a process group: make "
                           "them on every rank after torch.distributed."
                           "init_process_group (parallel.RankPool starts "
                           "such ranks)")
    return dist.get_world_size()


def make_obj_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """1-D ``('obj',)`` mesh for object tiling over the ranks of the default
    process group (``n_devices``, when given, must be the world size)."""
    world = _world()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"need {n} devices for a {n}-slab ('obj',) mesh, "
                         f"have {world} (the ranks of the process group)")
    return sharding._mesh(device_type, (n,), ("obj",))


def make_obj_scan_mesh(n_slabs: int, scan_shards: int,
                       device_type: str = "cuda"):
    """2-D ``('obj', 'scan')`` mesh composing object tiling (P3) with
    position sharding (P1): ``n_slabs`` object slabs, each slab's positions
    further sharded ``scan_shards`` ways; ``n_slabs * scan_shards`` must be
    the world size."""
    need, world = n_slabs * scan_shards, _world()
    if need != world:
        raise ValueError(f"need {need} devices for a {n_slabs}x"
                         f"{scan_shards} ('obj', 'scan') mesh, have {world}")
    return sharding._mesh(device_type, (n_slabs, scan_shards),
                          ("obj", "scan"))


def make_full_mesh(theta_shards: int, n_slabs: int, scan_shards: int,
                   device_type: str = "cuda"):
    """3-D ``('theta', 'obj', 'scan')`` mesh composing every parallel axis:
    P2 angle sharding x P3 object tiling x P1 position sharding."""
    need, world = theta_shards * n_slabs * scan_shards, _world()
    if need != world:
        raise ValueError(f"need {need} devices for a {theta_shards}x"
                         f"{n_slabs}x{scan_shards} ('theta', 'obj', "
                         f"'scan') mesh, have {world}")
    return sharding._mesh(device_type, (theta_shards, n_slabs, scan_shards),
                          ("theta", "obj", "scan"))


def _tensor(x):
    if torch.is_tensor(x):
        return x
    x = np.asarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def _owners(scan, geometry: Geometry, n_slabs: int, scan_shards: int):
    """(rows a slab owns, owner slab of every position (t, s) as numpy, the
    padded count of positions a slab holds per angle). One host read of
    the scan's rows."""
    g = geometry
    if g.nz % n_slabs != 0:
        raise ValueError(f"object rows ({g.nz}) must divide by the slab "
                         f"count ({n_slabs})")
    owned = g.nz // n_slabs
    halo = g.nprb - 1
    if owned < halo:
        raise ValueError(
            f"slab height ({owned}) must be >= nprb - 1 ({halo}): probe "
            "windows may only overlap into the immediate next slab")
    rows = _tensor(scan)[..., 0].detach().to("cpu", torch.float64).numpy()
    y_int = np.floor(rows).astype(np.int64)
    if (y_int < 0).any() or (y_int > g.nz - g.nprb).any():
        raise ValueError("scan positions out of bounds; run "
                         "tikejax_torch.models.check_scan first")
    owner = y_int // owned  # the slab of the window's top row
    counts = np.stack([(owner == d).sum(axis=1) for d in range(n_slabs)])
    s_loc = int(counts.max())
    s_loc = -(-max(s_loc, 1) // scan_shards) * scan_shards
    return owned, owner, s_loc


def _slab(psi0, scan, data, geometry: Geometry, d: int, owned: int, owner,
          s_loc: int):
    """Slab ``d`` of the partition: its object rows with the halo (the
    next slab's first rows; zero past the object), its slab-local scan
    positions in scan order padded with sentinels to ``s_loc`` per angle,
    and their frames (zero for the sentinels)."""
    g = geometry
    psi0, scan, data = _tensor(psi0), _tensor(scan), _tensor(data)
    halo = g.nprb - 1
    lo, hi = d * owned, min(d * owned + owned + halo, g.nz)
    psi = torch.zeros((g.ntheta, owned + halo, g.n), dtype=psi0.dtype,
                      device=psi0.device)
    psi[:, :hi - lo] = psi0[:, lo:hi]
    scan_loc = torch.zeros((g.ntheta, s_loc, 2), dtype=scan.dtype,
                           device=scan.device)
    scan_loc[..., 0] = -1
    data_p = torch.zeros((g.ntheta, s_loc) + tuple(data.shape[2:]),
                         dtype=data.dtype, device=data.device)
    for t in range(g.ntheta):
        idx = torch.from_numpy(np.nonzero(owner[t] == d)[0]).to(scan.device)
        sc = scan[t].index_select(0, idx)
        sc[:, 0] -= lo  # slab-local rows
        scan_loc[t, :len(idx)] = sc
        data_p[t, :len(idx)] = data[t].index_select(0, idx.to(data.device))
    return psi, scan_loc, data_p


def partition_problem(psi0, scan, data, geometry: Geometry, n_slabs: int,
                      scan_shards: int = 1):
    """The owner partition of a tiling problem.

    Returns ``(psi_slabs, scan_loc, data_p, owned)``: ``psi_slabs (D, t,
    owned + halo, n)`` the object slabs with their halo rows (the next
    slab's first rows; the last slab's halo is zero), ``scan_loc (D, t,
    s_max, 2)`` the slab-local (y, x) positions of each slab's owned
    positions in scan order -- padded per (slab, angle) to the largest
    owner count ``s_max`` with sentinel dummies (y = -1, which every
    kernel masks to zero) -- and ``data_p`` their frames (zero for the
    dummies). With ``scan_shards > 1`` (an ``('obj', 'scan')`` mesh)
    ``s_max`` is rounded up to a multiple of it, so that a slab's positions
    split evenly over its scan group. Takes numpy arrays or tensors and
    returns tensors on their devices.

    Raises ValueError when the object rows do not split equally, a slab is
    thinner than the halo, or a position is out of bounds.
    """
    owned, owner, s_loc = _owners(scan, geometry, n_slabs, scan_shards)
    slabs = [_slab(psi0, scan, data, geometry, d, owned, owner, s_loc)
             for d in range(n_slabs)]
    psi_slabs, scan_loc, data_p = (torch.stack(x) for x in zip(*slabs))
    return psi_slabs, scan_loc, data_p, owned


def stitch(psi_slabs, owned: int):
    """``(D, t, owned + halo, n)`` slabs -> the ``(t, D * owned, n)``
    object."""
    ownedv = psi_slabs[:, :, :owned]
    return ownedv.permute(1, 0, 2, 3).reshape(ownedv.shape[1], -1,
                                              ownedv.shape[3])


def _layout(mesh):
    """(theta dim or None, scan dim or None, theta shards, slabs, scan
    shards, this rank's theta index, slab, scan index) of a tiling mesh,
    with the reference's checks of its dimensions."""
    names = tuple(mesh.mesh_dim_names or ())
    if "obj" not in names:
        raise ValueError("run_tiled expects a mesh with an 'obj' axis; got "
                         f"axes {names}")
    theta = "theta" if "theta" in names else None
    others = [a for a in names if a not in ("obj", "theta")]
    if len(others) > 1:
        raise ValueError("run_tiled supports ('obj',), ('obj', <scan>) and "
                         "('theta', 'obj', <scan>) meshes; got "
                         f"{names}")
    scan = others[0] if others else None
    coord = tuple(mesh.get_coordinate())

    def size_at(name):
        return (1, 0) if name is None else (
            mesh.size(names.index(name)), coord[names.index(name)])

    (tsh, ti), (dsh, di), (ssh, si) = (size_at(theta), size_at("obj"),
                                       size_at(scan))
    return theta, scan, tsh, dsh, ssh, ti, di, si


def run_tiled(data, psi0, scan, prb0, geometry: Geometry, mesh,
              options: _cg.CGOptions | None = None, **kw):
    """Object-tiled CG reconstruction (P3), optionally composed with
    position sharding (P1) and angle sharding (P2); every rank calls it
    with the global arrays (see the module note).

    The semantics are those of :func:`tikejax_torch.solvers.run` up to the
    order of float sums: the object rows and the scan positions are
    partitioned over the mesh's ``'obj'`` dimension (and the positions of a
    slab over its scan dimension, the angles over ``'theta'``), the whole
    object never lives on one rank, and the result is stitched back.

    Args:
      data, psi0, scan, prb0: the global problem (numpy or tensors on this
        rank's device); the partition happens here.
      mesh: a ``('obj',)`` mesh (:func:`make_obj_mesh`), an ``('obj',
        'scan')`` mesh (:func:`make_obj_scan_mesh`) or a ``('theta',
        'obj', 'scan')`` mesh (:func:`make_full_mesh`).

    Returns:
      (psi, prb, metrics): psi the stitched ``(ntheta, nz, n)`` object and
      prb the probe, both global on every rank; metrics the same on every
      rank.
    """
    import torch.distributed as dist

    if options is None:
        options = _cg.CGOptions(**kw)
    elif kw:
        options = dataclasses.replace(options, **kw)
    psi0, scan, data, prb0 = (_tensor(x) for x in (psi0, scan, data, prb0))
    options = _cg.normalize_options(options,
                                    diffraction._backend(psi0.device))
    # The solver's slab checks, which every rank would make, before the
    # mesh is touched: obj_slabs > 1 is for one device.
    _cg.check_slabs(options, diffraction._backend(psi0.device),
                    on_mesh=True)
    g = geometry
    theta_ax, scan_ax, tsh, dsh, ssh, ti, di, si = _layout(mesh)
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} ranks, the process "
                         f"group {dist.get_world_size()}: a mesh must span "
                         "every rank")
    if g.ntheta % tsh != 0:
        raise ValueError(f"ntheta ({g.ntheta}) must divide by the theta "
                         f"mesh axis ({tsh})")
    owned, owner, s_loc = _owners(scan, g, dsh, ssh)
    halo = g.nprb - 1
    if options.carry_state:
        raise ValueError(
            "carry_state is not supported under object tiling: the "
            "carried cg_state rides in the replicated metrics, but its "
            "object-domain entries are per-slab (use run_sharded on a "
            "1-D scan mesh for carried segments)")
    psi_l, scan_l, data_l = _slab(psi0, scan, data, g, di, owned, owner,
                                  s_loc)
    t_local, per = g.ntheta // tsh, s_loc // ssh
    angles = slice(ti * t_local, (ti + 1) * t_local)
    positions = slice(si * per, (si + 1) * per)
    # Contiguous: the kernels read the data in place on every evaluation.
    data_l = data_l[angles, positions].contiguous()
    scan_l = scan_l[angles, positions].contiguous()
    psi_l = psi_l[angles].contiguous()
    prb_l = prb0[angles].contiguous()
    g_local = dataclasses.replace(g, nz=owned + halo, ntheta=t_local,
                                  nscan=per)
    opts = dataclasses.replace(options, obj_axis_name="obj", obj_halo=halo,
                               obj_axis_size=dsh, axis_name=scan_ax,
                               theta_axis_name=theta_ax)
    psi, prb, metrics = _cg.run_impl(g_local, opts, data_l, psi_l, scan_l,
                                     prb_l, mesh=mesh)
    # The owned rows of every (angle, slab) into a zero-filled global
    # object, summed over the ranks that hold different ones (those of one
    # scan group hold the same).
    full = torch.zeros((g.ntheta, g.nz, g.n), dtype=psi.dtype,
                       device=psi.device)
    full[angles, di * owned:(di + 1) * owned] = psi[:, :owned]
    full = _cg._Comm(opts, mesh).over_theta(full, "psi")
    if tsh > 1:  # the angles' probes, likewise over the theta dimension
        prb_full = torch.zeros((g.ntheta,) + tuple(prb.shape[1:]),
                               dtype=prb.dtype, device=prb.device)
        prb_full[angles] = prb
        prb = _cg.all_reduce(prb_full, mesh.get_group("theta"))
    return full, prb, metrics
