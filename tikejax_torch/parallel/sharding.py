"""Position (P1) and angle (P2) sharding on ``torch.distributed``.

Counterpart of ``tikejax.parallel.sharding``:

* **P1 position sharding**: the scan axis of ``scan`` and ``data`` is split
  over a ``'scan'`` mesh dimension; the object and the probe are
  replicated, and the objective, the object and probe gradients and every
  line-search value are summed over the ranks each iteration;
* **P2 angle sharding**: a 2-D ``('theta', 'scan')`` mesh also splits the
  angles; the object, the probe and their gradients stay per angle, with no
  collective, while the scalars (objective, line search, the Dai-Yuan and
  L-BFGS inner products) are summed over both dimensions, so every rank
  takes the same steps.

Execution model. The JAX package is ONE controller over a ``shard_map``:
the caller hands global arrays to one call, and XLA runs the per-device
body and its ``psum``\\ s. Here EVERY rank calls :func:`run_sharded` (each in
its own process, in one gloo process group: ``parallel.RankPool`` starts
such ranks), with the global arrays or with its own slice of them, and runs
``solvers.cg.run_impl`` on its local geometry; the solver all-reduces where
the JAX package ``psum``\\ s (``tikejax_torch.solvers.cg``). The step control
is on the host and every branch reads an all-reduced value, so the ranks
stay in lock step; gloo's all-reduce hands every rank the same bits, so the
replicated object and probe stay bitwise equal across ranks. psi and prb
come back as global tensors on every rank (as JAX's global arrays read); on
a theta mesh they are gathered with an all-reduce of zero-filled global
tensors over the theta dimension, since gloo takes CUDA tensors only for
``all_reduce`` and ``broadcast``. The metrics are the same on every rank.
On a theta mesh the carried ``cg_state`` stays per angle, as the JAX
package's does. The meshes span every rank of the process group.

The JAX package's ``_call_checked`` and ``_SHARDED_CACHE`` (``check_vma``
and the jit memo) are tracing machinery with no eager counterpart.
"""

from __future__ import annotations

import dataclasses

import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.ops import diffraction
from tikejax_torch.solvers import cg as _cg

_MESHES: dict = {}


def make_mesh(n_devices: int | tuple[int, int] | None = None,
              axis: str = "scan", device_type: str = "cuda"):
    """Device mesh for position (1-D) or angle x position (2-D) sharding,
    over the ranks of the default process group (which must be up).

    Args:
      n_devices: the number of ranks (default: all), or a ``(ntheta_shards,
        nscan_shards)`` tuple for a 2-D ``('theta', 'scan')`` mesh. It must
        be the world size.
      axis: the dimension's name of a 1-D mesh.
      device_type: 'cuda' (the default: the ranks' cards) or 'cpu'.

    Returns:
      a ``torch.distributed.device_mesh.DeviceMesh``; every rank must make
      the same meshes in the same order (a new mesh makes process groups, a
      collective). A mesh made before is returned again.
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call it on "
                           "every rank after torch.distributed."
                           "init_process_group (parallel.RankPool starts "
                           "such ranks)")
    world = dist.get_world_size()
    if isinstance(n_devices, tuple):
        t, s = n_devices
        shape, names = (t, s), ("theta", "scan")
    else:
        shape, names = (world if n_devices is None else n_devices,), (axis,)
    size = 1
    for d in shape:
        size *= d
    if size != world:
        raise ValueError(f"mesh {n_devices} needs {size} devices, have "
                         f"{world} (the ranks of the process group)")
    return _mesh(device_type, shape, names)


def _mesh(device_type: str, shape: tuple, names: tuple):
    """The ``DeviceMesh`` of ``shape`` and dimension ``names`` over every
    rank, made once per process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    # Keyed on the default group too: a mesh of a destroyed process group
    # holds groups that are gone.
    key = (dist.group.WORLD, device_type, shape, names)
    if key not in _MESHES:
        for old in [k for k in _MESHES if k[0] is not key[0]]:
            del _MESHES[old]
        _MESHES[key] = init_device_mesh(device_type, shape,
                                        mesh_dim_names=names)
    return _MESHES[key]


def _axes(mesh) -> tuple[str | None, str]:
    """(theta dimension or None, scan dimension) of a 1-D or 2-D mesh."""
    names = mesh.mesh_dim_names
    if names is None or len(names) not in (1, 2):
        raise ValueError(f"expected a 1-D or 2-D mesh with named "
                         f"dimensions, got {names}")
    if "obj" in names:
        raise ValueError(f"a mesh with an 'obj' dimension ({names}) tiles "
                         "the object: run it through "
                         "tikejax_torch.parallel.run_tiled")
    if len(names) == 1:
        return None, names[0]
    return names[0], names[1]


def _check_mesh(mesh) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh must be a torch.distributed DeviceMesh "
                         f"(parallel.make_mesh), got {type(mesh).__name__}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} ranks, the process "
                         f"group {dist.get_world_size()}: a mesh must span "
                         "every rank")


def _layout(mesh):
    """(theta dim, scan dim, theta shards, scan shards, this rank's theta
    index, its scan index)."""
    theta_ax, scan_ax = _axes(mesh)
    names = mesh.mesh_dim_names
    coord = tuple(mesh.get_coordinate())
    nsh = mesh.size(names.index(scan_ax))
    si = coord[names.index(scan_ax)]
    if theta_ax is None:
        return theta_ax, scan_ax, 1, nsh, 0, si
    return (theta_ax, scan_ax, mesh.size(names.index(theta_ax)), nsh,
            coord[names.index(theta_ax)], si)


def pad_scan_problem(data, scan, geometry: Geometry, nsh: int):
    """Pad the scan axis to a multiple of ``nsh`` with sentinel dummy
    positions (scan row -1, zero data; see ops.patches) so that every
    shard gets an equal slice. Returns (data, scan, geometry), unchanged
    when ``nscan`` already divides."""
    if geometry.nscan % nsh == 0:
        return data, scan, geometry
    s_pad = -(-geometry.nscan // nsh) * nsh
    extra = s_pad - geometry.nscan
    pad_scan = torch.zeros((scan.shape[0], extra, 2), dtype=scan.dtype,
                           device=scan.device)
    pad_scan[..., 0] = -1
    pad_data = torch.zeros(data.shape[:1] + (extra,) + data.shape[2:],
                           dtype=data.dtype, device=data.device)
    return (torch.cat([data, pad_data], dim=1),
            torch.cat([scan, pad_scan], dim=1),
            dataclasses.replace(geometry, nscan=s_pad))


def _angle_slice(x, tsh: int, ti: int, axis: int = 0):
    """This rank's angles of a global object-domain array (axis ``axis``
    holds the angles)."""
    if tsh == 1:
        return x
    per = x.shape[axis] // tsh
    return x.narrow(axis, ti * per, per)


def shard_problem(mesh, data, scan, axis: str | None = None):
    """This rank's slice of ``data`` and ``scan``: its positions (and on a
    2-D mesh its angles). The scan axis must divide by the scan dimension
    (pad with :func:`pad_scan_problem` first). ``axis`` names the scan
    dimension (default: the mesh's)."""
    _check_mesh(mesh)
    theta_ax, scan_ax, tsh, nsh, ti, si = _layout(mesh)
    if axis is not None and axis != scan_ax:
        raise ValueError(f"axis {axis!r} is not the mesh's scan dimension "
                         f"{scan_ax!r}")
    s = scan.shape[1]
    if s % nsh or data.shape[1] != s:
        raise ValueError(f"the scan axis ({s} positions) must divide by the "
                         f"mesh's scan dimension ({nsh}); pad with "
                         "pad_scan_problem")
    if scan.shape[0] % tsh:
        raise ValueError(f"ntheta ({scan.shape[0]}) must be divisible by "
                         f"the theta mesh axis size ({tsh})")
    per = s // nsh
    # Contiguous (a copy only with several angles a rank): the kernels read
    # the data in place on every evaluation.
    data = _angle_slice(data, tsh, ti)[:, si * per:(si + 1) * per]
    scan = _angle_slice(scan, tsh, ti)[:, si * per:(si + 1) * per]
    return data.contiguous(), scan.contiguous()


def fwd_sharded(psi, scan, prb, ndet: int, kernel: str, mesh):
    """Position-sharded forward diffraction: ``scan`` is this rank's slice
    (:func:`shard_problem`), ``psi`` and ``prb`` global (or this rank's
    angles); returns this rank's farplane slice. ``reconstruct`` freezes
    its base farplanes with it on a mesh."""
    _check_mesh(mesh)
    _, _, tsh, _, ti, _ = _layout(mesh)
    t_local = scan.shape[0]
    if psi.shape[0] != t_local:
        psi = _angle_slice(psi, tsh, ti)
    if prb.shape[0] != t_local:
        prb = _angle_slice(prb, tsh, ti)
    return diffraction.fwd_raw(psi, scan, prb, ndet, kernel)


def _shard_base(f_base, tsh: int, nsh: int, ti: int, si: int):
    """This rank's slice of a global base farplane (complex, or the
    ``view_as_real`` halves of one), as one contiguous complex tensor."""
    from tikejax_torch.ops import fused

    b = _angle_slice(fused._base_complex(f_base), tsh, ti)
    per = b.shape[1] // nsh
    return b[:, si * per:(si + 1) * per].contiguous()


def _local_cg_init(cg_init, t_local: int, tsh: int, ti: int):
    """This rank's angles of a carried state given globally: the (d, g)
    slots and the S/Y rings (angles at axis 1); scalars pass through."""
    if cg_init is None or tsh == 1:
        return cg_init
    ci = list(cg_init)
    for i in (0, 1):
        if ci[i].shape[0] != t_local:
            ci[i] = _angle_slice(ci[i], tsh, ti)
    for i in (4, 5):
        if i < len(ci) and ci[i].shape[1] != t_local:
            ci[i] = _angle_slice(ci[i], tsh, ti, axis=1)
    return tuple(ci)


def gather_angles(x, mesh, axis: int = 0):
    """A global tensor from this rank's angles of an object-domain array
    on a 2-D mesh: each rank writes its angles into a zero-filled global
    tensor and the theta dimension's all-reduce sums them (every rank gets
    the same bits). ``x`` as it is on a 1-D mesh."""
    theta_ax, _, tsh, _, ti, _ = _layout(mesh)
    if theta_ax is None or tsh == 1:
        return x
    shape = list(x.shape)
    per = shape[axis]
    shape[axis] = per * tsh
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(axis, ti * per, per).copy_(x)
    return _cg.all_reduce(full, mesh.get_group(theta_ax))


def gather_state(cg_state, mesh):
    """A carried ``cg_state`` with its per-angle entries gathered into
    global tensors (:func:`gather_angles`), e.g. for a checkpoint; scalars
    pass through."""
    if cg_state is None:
        return None
    cs = list(cg_state)
    for i in (0, 1):
        cs[i] = gather_angles(cs[i], mesh)
    for i in (4, 5):
        if i < len(cs):
            cs[i] = gather_angles(cs[i], mesh, axis=1)
    return tuple(cs)


def run_sharded(data, psi0, scan, prb0, geometry: Geometry, mesh,
                options: _cg.CGOptions | None = None, f_base=None,
                cg_init=None, **kw):
    """Position- (and angle-) sharded CG reconstruction; every rank calls
    it (see the module note).

    The semantics are those of :func:`tikejax_torch.solvers.run` up to the
    order of float sums: the scan axis of ``scan`` and ``data`` is split
    over the mesh, and the gradients and objectives are summed over it every
    iteration.

    Args:
      data, scan: the global arrays (``geometry.nscan`` positions; an
        ``nscan`` that does not divide by the scan dimension is padded with
        sentinel-masked dummies, which every kernel treats as adding exactly
        zero), or this rank's slice (:func:`shard_problem` of a padded
        problem).
      psi0, prb0: global, or this rank's angles.
      mesh: a 1-D mesh (its dimension shards the positions) or a 2-D
        ``('theta', 'scan')`` mesh (:func:`make_mesh`); ``ntheta`` must
        divide by the theta dimension.
      f_base: the frozen base farplane (cg.run's ``f_base``), sharded like
        the data; the scan axis must already be a multiple of the scan
        dimension (pre-pad with :func:`pad_scan_problem` and compute the
        base farplane on the padded problem, e.g. with
        :func:`fwd_sharded`).
      cg_init: a carried state (cg.run's ``cg_init``): global, or this
        rank's angles on a theta mesh (what ``metrics['cg_state']`` holds
        there).

    Returns:
      (psi, prb, metrics): psi and prb global on every rank; metrics the
      same on every rank (``metrics['cg_state']`` per angle on a theta
      mesh).
    """
    if options is None:
        options = _cg.CGOptions(**kw)
    elif kw:
        options = dataclasses.replace(options, **kw)
    # The solver's slab checks, which every rank would make, before the
    # mesh is touched: obj_slabs > 1 is for one device.
    _cg.check_slabs(options, diffraction._backend(psi0.device),
                    on_mesh=True)
    _check_mesh(mesh)
    for name, default in _cg.OBJ_FIELDS.items():
        if getattr(options, name) != default:
            raise ValueError(f"run_sharded: {name} names object tiling; "
                             "run through tikejax_torch.parallel.run_tiled")
    options = _cg.normalize_options(options,
                                    diffraction._backend(psi0.device))
    theta_ax, scan_ax, tsh, nsh, ti, si = _layout(mesh)
    if geometry.ntheta % tsh:
        raise ValueError(f"ntheta ({geometry.ntheta}) must be divisible by "
                         f"the theta mesh axis size ({tsh})")
    t_local = geometry.ntheta // tsh
    s_pad = -(-geometry.nscan // nsh) * nsh
    if geometry.nscan % nsh and f_base is not None:
        raise ValueError(
            "f_base must match a pre-padded scan axis (a multiple of the "
            f"mesh axis {nsh}); pad with pad_scan_problem and compute the "
            "base farplane on the padded problem")
    if tuple(scan.shape[:2]) == (geometry.ntheta, geometry.nscan):
        # The global arrays: pad, then keep this rank's slice.
        data, scan, geometry = pad_scan_problem(data, scan, geometry, nsh)
        data, scan = shard_problem(mesh, data, scan)
        if f_base is not None:
            f_base = _shard_base(f_base, tsh, nsh, ti, si)
    elif tuple(scan.shape[:2]) != (t_local, s_pad // nsh):
        raise ValueError(
            f"scan has shape {tuple(scan.shape)}: neither the global "
            f"({geometry.ntheta}, {geometry.nscan}) positions nor this "
            f"rank's slice ({t_local}, {s_pad // nsh})")
    g_local = dataclasses.replace(geometry, nscan=s_pad // nsh,
                                  ntheta=t_local)
    if psi0.shape[0] != t_local:
        psi0 = _angle_slice(psi0, tsh, ti)
    if prb0.shape[0] != t_local:
        prb0 = _angle_slice(prb0, tsh, ti)
    cg_init = _local_cg_init(cg_init, t_local, tsh, ti)
    options = dataclasses.replace(options, axis_name=scan_ax,
                                  theta_axis_name=theta_ax)
    psi, prb, metrics = _cg.run_impl(g_local, options, data, psi0, scan,
                                     prb0, f_base, cg_init, mesh=mesh)
    return gather_angles(psi, mesh), gather_angles(prb, mesh), metrics
