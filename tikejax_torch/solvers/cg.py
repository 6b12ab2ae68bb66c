"""Conjugate-gradient ptychography solver: the object, and with
``recover_prb`` the probe too.

Counterpart of ``tikejax.solvers.cg``: the same options (same names and
defaults), the same Dai-Yuan and two-loop L-BFGS directions, warm-started
backtracking (or interpolating, or parabola-refined) line search,
illumination preconditioners (with the optional low-frequency boost),
stopping rules and metrics, joint object+probe recovery (an object step,
then a Dai-Yuan probe step at the updated object), position streaming
(``nchunks``), the split-operator mode (``f_base``), the two memory
regimes (``memory``), the fused one-pass line search
(``fused_linesearch``) and the carried CG state (``cg_init`` /
``carry_state`` / ``carry_lbfgs``) that ``solvers.reconstruct`` threads
across its refinement segments. Three loop bodies, as in the JAX package:

* the MERGED body (the main path on CUDA, ``kernel='fused*'``, frameless,
  object-only and unstreamed): every line-search candidate is evaluated by
  one ``grad_fused`` pass, which returns the objective and the gradient
  together, so the accepted candidate's gradient seeds the next iteration;
* the frameless CLASSIC body (``kernel='fused*'`` with
  ``merged_linesearch='off'``, ``recover_prb`` or ``fused_linesearch``):
  one ``grad_fused`` pass (and for the probe step one ``grad_prb_fused``
  pass) per iteration, then a line search that evaluates every candidate
  with one ``minf_fused`` pass -- nothing farplane-sized is allocated;
* the materialized CLASSIC body (``memory='materialized'`` on the fused
  tiers, ``kernel='xla'``, the 'auto' choice off CUDA, and the hybrid
  ``kernel='pallas'``): the farplane
  ``G psi`` (plus the base) is kept between the gradient pass and the line
  search. On the fused tiers the object gradient is one ``fwd`` and one
  ``adj_residual`` pass, the probe gradient ``fwd`` then ``adj_probe``, and
  the line search evaluates its candidates on the per-pixel statistics
  ``(a, b, c)`` that one ``fwd_quad_stats`` pass makes from ``G psi`` and
  the direction -- or, with ``fused_linesearch``, takes the first accepted
  of all ``max_halvings + 1`` steps from one ``ls_objectives`` pass over
  ``G psi`` and the direction's farplane (``fwd``). On ``'xla'`` both passes
  run the oracle operators; on ``'pallas'`` the same operators with cuFFT
  between the ``gather_probe_mul``, ``scatter_conj_probe`` and
  ``adj_probe_reduce`` kernels of ``tikejax_torch.ops.kernels``.

With ``nchunks > 1`` the classic body streams both passes over
``nchunks`` chunks of positions: the gradient pass sums the chunks'
objectives and adjoints (on the fused tiers the ``fwd``, ``adj`` and
``adj_probe`` kernels), and the line search keeps the per-pixel quadratic
statistics ``(a, b, c)`` of every chunk and evaluates each candidate from
them, as the JAX package does.

Execution model. The JAX package runs the whole loop, data-dependent
``while_loop``s included, in one jit with no host round trip. Eager PyTorch
cannot branch on ``f(candidate) > f(current)`` without reading the value, so
this solver keeps the step control on the host and reads ONE scalar per
line-search candidate (plus the directional derivative when the 'interp'
step needs it, the inner products of an L-BFGS direction at once, and two
scalars at the start). Everything array-valued
stays on the device. ``metrics['host_syncs']`` counts the reads and
``metrics['evaluations']`` the objective evaluations; a fused line search
(one ``ls_objectives`` pass) counts as one evaluation and one read, since
it reads its K values at once. The scalar slots of
the carried state (steps, the L-BFGS curvature ring and count) are host
values, kept as 0-d or 1-d CPU tensors.

On a mesh (``axis_name`` / ``theta_axis_name``, set by
``tikejax_torch.parallel.run_sharded``, and ``obj_axis_name`` /
``obj_halo`` / ``obj_axis_size``, set by ``tikejax_torch.parallel.
run_tiled``, each of which hands ``run_impl`` the ``DeviceMesh`` and the
rank's slice of the problem) every rank runs this loop on its own
positions, and the solver all-reduces (``torch.distributed``) exactly where
the JAX package ``psum``s: the objective and every line-search value over
all ranks; the object gradient and the illumination map over the scan axis
and then, under object tiling, through the halo exchange over the object
axis (:func:`halo_exchange`, the JAX package's ``_halo_fix``), the
illumination map's per-angle maximum over the object axis too; the probe
gradient and its ``seen`` map over the scan and object axes; the
object-domain inner products over the theta and object axes on the owned
rows only (the halo rows mirror the next slab's), the probe-domain ones
over the theta axis; ``sum(data)`` and the Poisson offset over all ranks.
Every branch of the step control then reads an all-reduced value, so the
ranks stay in lock step, and the all-reduce hands every rank the same bits
(gloo's sum on the host, sent to every rank; NCCL's, where every rank has a
card of its own, reduces each element once on the cards and sends it on),
so a replicated object stays bitwise equal across ranks. Under NCCL every
reduced tensor lives on the rank's card and the collective is queued in
the card's stream order, so the host read that follows it waits for it.
:func:`all_reduce` and :func:`halo_exchange` count the collectives.

The slab fields (``obj_slabs``, ``obj_slabs_partitioned``,
``obj_slab_rows``, ``obj_slab_cols``, ``kernel_frames``) are the JAX
package's answer to its TPU's scoped-VMEM object cap: there the fused
kernels stream the object in row slabs over a y-sorted, padded partition of
the positions. Here the kernels read the object from device memory through
the scan's corners whatever its size, so a valid slab request runs the
whole-object solve in the caller's scan order: ``run(obj_slabs=D)`` returns
``run()``'s bits, which the JAX package's own slab runs match only to its
tests' tolerances (residual rtol 2e-4, psi 1e-3), its partition having
reordered and padded the positions. The fields are validated as the JAX
package validates them (:func:`check_slabs`, and ``obj_slab_cols`` in
:func:`run`); no partition, slab planner or compile-retry ladder is applied
(``run`` calls ``run_impl`` directly).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.models import likelihoods
from tikejax_torch.ops import diffraction, fused, lbfgs, linesearch
from tikejax_torch.ops import patches as _patches
from tikejax_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class CGOptions:
    """Solver configuration; the fields and defaults of the JAX package's
    ``CGOptions`` that this port implements.

    Attributes:
      piter: maximum number of CG iterations.
      model: 'gaussian' or 'poisson' likelihood.
      step0: initial line-search step.
      step_shrink: backtracking shrink factor.
      max_halvings: bound on backtracking steps (then gamma=0, no move).
      kernel: 'auto' (fused_mx on CUDA -- fused_hp for a deep
        target_residual, 'fused' for a shallow one -- and 'xla'
        elsewhere), any 'fused*' tier (all run the fp32 kernels of
        ``tikejax_torch.ops.fused``), 'pallas' (the hybrid tier: cuFFT
        between the kernels of ``tikejax_torch.ops.kernels``) or 'xla' (the
        oracle operators).
      precondition: 'illum' (divide the object gradient by the
        probe-illumination map, and the probe gradient by the object power
        each probe pixel sees, each floored at 10% of its maximum; under
        recover_prb the object's map follows the current probe),
        'illum_lowk' ('illum', then the gradient's spectrum times the real
        positive symbol 1 + lowk_boost * k0^2 / (k0^2 + |k|^2), k0 =
        lowk_frac * Nyquist; object-only), 'max' (the object gradient times
        the scalar 1/max sum_m |prb_m|^2) or 'none'.
      verbose_every: if > 0, print (iteration, minf, gamma) every N
        iterations.
      lowk_boost, lowk_frac: the 'illum_lowk' filter's boost amplitude
        (>= 0) and crossover as a fraction of Nyquist (in (0, 0.5]).
      adaptive_step: warm-start the line search from the previous step.
      step_growth: warm-start regrow factor (>= 1).
      step_policy: 'regrow' (start from min(step0, growth * previous
        accepted step)), 'track' (grow only after an outright accept) or
        'auto' (= 'regrow').
      fused_linesearch: evaluate the whole backtracking candidate set
        {gamma0 * step_shrink^k, k = 0..max_halvings} in one
        ``ls_objectives`` pass over the two farplanes and take the first
        step that does not raise the objective (gamma = 0 if none), instead
        of the candidate-by-candidate search; the 'interp' step plays no
        part in it. It applies only in the materialized regime, unstreamed,
        on a fused tier; it also switches the merged body off (so in the
        frameless regime it runs the classic body, one ``minf_fused`` pass
        per candidate). Off by default, as in the JAX package, which
        measured it slower on its TPU.
      target_residual: stop once the relative residual reaches this
        (0 disables).
      direction: 'auto' (= 'dy' here; ``solvers.reconstruct`` resolves it
        to 'lbfgs' for its refinement segments), 'dy' (Dai-Yuan) or
        'lbfgs' / 'lbfgs:<m>' (two-loop L-BFGS on the preconditioned
        gradient over a ring of the last m (s, y) pairs, default m=8,
        curvature-guarded; a fully-failed line search clears the memory).
      stop_on_stall: stop after this many consecutive fully-failed line
        searches (0 disables).
      linesearch: 'backtracking', 'interp' (one safeguarded quadratic-
        interpolation step on the first rejection), 'parabolic'
        (backtracking, then the accepted step refined to the vertex of the
        parabola through the objective at 0, gamma/2 and gamma: two more
        evaluations; it runs the classic body) or 'auto' (backtracking on
        the fused_mp/hp/mx/hx tiers, interp otherwise).
      recover_prb: also recover the probe: after each object step, a
        Dai-Yuan step on the probe at the updated object, with its own
        warm-started line search (``metrics['gamma_prb']``).
      nchunks: stream the passes over this many chunks of positions (it
        must divide nscan): the gradient pass never holds more than one
        chunk's farplane, and the line search keeps the quadratic
        statistics of every chunk.
      memory: 'frameless' (the fused kernels never store a farplane),
        'materialized' (keep ``G psi`` in memory between the forward pass
        and the gradient tail, for the line search to reuse) or 'auto'
        (frameless on the fused tiers; 'xla' has no frameless path).
      merged_linesearch: 'auto' (evaluate every candidate with its
        gradient on the fused path) or 'off' (on the fused path: one
        gradient pass per iteration and one ``minf_fused`` pass per
        candidate).
      carry_state: return the terminal CG state (direction, the
        preconditioned gradient that built it, accepted step, step start)
        in ``metrics['cg_state']``, to continue the trajectory in a later
        run through ``cg_init``.
      carry_lbfgs: with an L-BFGS direction, also carry the (S, Y, sy,
        count) ring (the 8-tuple layout); implies carry_state.
      axis_name: the mesh dimension that shards the scan positions (set by
        ``tikejax_torch.parallel.run_sharded``; needs its mesh).
      theta_axis_name: the mesh dimension that shards the angles, likewise.
      obj_slabs, obj_slabs_partitioned, obj_slab_rows, obj_slab_cols,
        kernel_frames: the JAX package's object row-slab fields (the TPU's
        answer to its scoped-VMEM object cap: slabs of rows, the positions
        partitioned among them, frames per kernel step). They are accepted
        and validated as there -- ``obj_slabs >= 1``; ``obj_slabs > 1``
        only on a fused tier, frameless, with ``nchunks == 1`` and off a
        mesh; ``obj_slab_cols >= 1`` -- and change nothing: a valid slab
        request runs the whole-object solve in the caller's scan order and
        returns the bits of the same call without them (the JAX package's
        slab runs follow its whole-object run to residual rtol 2e-4 and
        psi 1e-3). No partition is applied.
    """

    # In the JAX package's order, so that a positional construction means
    # the same in both.
    piter: int = 32
    model: str = "gaussian"
    recover_prb: bool = False
    step0: float = 1.0
    step_shrink: float = 0.5
    max_halvings: int = 16
    nchunks: int = 1
    kernel: str = "auto"
    axis_name: str | None = None
    theta_axis_name: str | None = None
    # Object-domain tiling (P3, tikejax_torch.parallel.tiling): the object's
    # rows are cut into obj_axis_size slabs over the mesh dimension
    # obj_axis_name; each rank holds its owned rows plus obj_halo halo rows
    # below, which mirror the next slab's first rows (the probe-window
    # overlap). run_tiled sets all three.
    obj_axis_name: str | None = None
    obj_halo: int = 0
    obj_axis_size: int = 1
    verbose_every: int = 0
    precondition: str = "illum"
    lowk_boost: float = 4.0
    lowk_frac: float = 0.05
    adaptive_step: bool = True
    step_growth: float = 4.0
    step_policy: str = "auto"
    fused_linesearch: bool = False
    target_residual: float = 0.0
    direction: str = "auto"
    stop_on_stall: int = 2
    linesearch: str = "auto"
    memory: str = "auto"
    merged_linesearch: str = "auto"
    carry_state: bool = False
    carry_lbfgs: bool = False
    obj_slabs: int = 1
    obj_slabs_partitioned: bool = False
    obj_slab_rows: tuple | None = None
    obj_slab_cols: int = 1
    kernel_frames: int | None = None


# The object-tiling fields, which only run_tiled's mesh gives a meaning.
OBJ_FIELDS = {"obj_axis_name": None, "obj_halo": 0, "obj_axis_size": 1}
# The fields that name a mesh dimension.
MESH_AXES = ("axis_name", "obj_axis_name", "theta_axis_name")


def check_slabs(o: CGOptions, backend: str, on_mesh: bool = False) -> None:
    """The JAX package's checks of ``obj_slabs`` (its ``_Engine``'s), in its
    order and with its exception type and wording: at least 1, and above 1
    only on a fused tier, frameless, unstreamed and off a mesh (``on_mesh``,
    or a mesh axis named in ``o``). ``backend`` ('cuda' or 'cpu') resolves
    ``kernel='auto'``."""
    if o.obj_slabs < 1:
        raise ValueError(f"obj_slabs must be >= 1, got {o.obj_slabs}")
    if o.obj_slabs == 1:
        return
    fused_tier = diffraction.resolve_kernel(o.kernel, backend).startswith(
        "fused")
    if not fused_tier:
        raise ValueError("obj_slabs > 1 requires a fused kernel tier (the "
                         "JAX package's slabs stream its fused kernels' "
                         "object; 'xla' and 'pallas' have none)")
    if o.memory not in ("frameless", "auto"):
        raise ValueError("obj_slabs > 1 requires the frameless memory "
                         "policy (memory='auto' or 'frameless')")
    if o.nchunks != 1:
        raise ValueError("obj_slabs > 1 already streams the positions "
                         "slab by slab; combine with nchunks == 1")
    if on_mesh or any(getattr(o, a) is not None for a in MESH_AXES):
        raise ValueError("obj_slabs composes with single-device runs only; "
                         "on a mesh use tikejax_torch.parallel.run_tiled "
                         "(P3 object tiling)")


def _count(fn, nbytes: int) -> None:
    fn.launches += 1
    fn.bytes += nbytes
    fn.sizes[nbytes] = fn.sizes.get(nbytes, 0) + 1


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op='max'``: its maximum) over the ranks of the
    process ``group`` (``torch.distributed.all_reduce``, in place on a
    contiguous ``x``, which is returned). Counts its calls in
    ``all_reduce.launches``, the bytes it reduced in ``all_reduce.bytes``
    and the calls by size in ``all_reduce.sizes`` ({bytes: calls}). On
    NCCL ``x`` is on the rank's card and stays there; gloo takes CPU and
    CUDA tensors (a CUDA tensor through the host)."""
    import torch.distributed as dist

    with span("cg.all_reduce"):
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
    _count(all_reduce, x.numel() * x.element_size())
    return x


all_reduce.launches = 0
all_reduce.bytes = 0
all_reduce.sizes = {}


def halo_exchange(x: torch.Tensor, pairs, halo: int) -> torch.Tensor:
    """The JAX package's ``_halo_fix`` of a slab-tiled object-domain
    array ``x`` (t, owned + halo, n), in place, returned:

    1. each slab's halo rows (partial sums that belong to the next slab's
       first rows) go forward and are added there;
    2. each slab's completed first rows go back into the previous slab's
       halo rows, which so mirror them again; the last slab's halo rows
       are zero (no slab follows it).

    ``pairs`` is this rank's ``[(d, group, rank of slab d, rank of slab d +
    1)]`` of the pair groups ``{d, d + 1}`` along the object dimension that
    it belongs to, in increasing ``d`` (:class:`_Comm`). Each step is a
    ``torch.distributed.broadcast`` in a pair group, which gloo takes for
    CUDA tensors, as it takes no point-to-point send (NCCL takes the same
    broadcast): every rank walks its pairs in one global order, a chain
    serial in the number of slabs.
    Counts each broadcast it takes part in in ``halo_exchange.launches``,
    ``.bytes`` and ``.sizes``, as :func:`all_reduce` counts."""
    import torch.distributed as dist

    owned = x.shape[1] - halo
    me = dist.get_rank()
    with span("cg.halo_exchange"):
        for back in (False, True):
            for _, group, lo, hi in pairs:
                sending = (me == hi) if back else (me == lo)
                strip = (x[:, :halo] if back else x[:, owned:]).contiguous()
                buf = strip if sending else torch.empty_like(strip)
                dist.broadcast(torch.view_as_real(buf) if buf.is_complex()
                               else buf, src=hi if back else lo, group=group)
                _count(halo_exchange, buf.numel() * buf.element_size())
                if not sending and back:
                    x[:, owned:] = buf
                elif not sending:
                    x[:, :halo] += buf
        if not any(lo == me for _, _, lo, _ in pairs):
            x[:, owned:] = 0  # the last slab
    return x


halo_exchange.launches = 0
halo_exchange.bytes = 0
halo_exchange.sizes = {}


def _mesh_groups(mesh, dims: tuple[str, ...]):
    """The process group of this rank over the mesh dimensions ``dims``
    together (the ranks that share its coordinates along every other
    dimension), made once per mesh and kept on it. Every rank makes every
    such group, in the same order: a new group is a collective. A group
    takes the default group's collective timeout."""
    import torch.distributed as dist

    from tikejax_torch.parallel._ranks import group_timeout

    cache = mesh.__dict__.setdefault("_tikejax_groups", {})
    if dims not in cache:
        names = mesh.mesh_dim_names
        layout = mesh.mesh.permute(
            [names.index(d) for d in names if d not in dims]
            + [names.index(d) for d in dims])
        me = dist.get_rank()
        mine = None
        for ranks in layout.reshape(-1, math.prod(
                mesh.size(names.index(d)) for d in dims)).tolist():
            group = dist.new_group(ranks, timeout=group_timeout())
            if me in ranks:
                mine = group
        cache[dims] = mine
    return cache[dims]


def _halo_pairs(mesh, dim: str):
    """This rank's pair groups ``{d, d + 1}`` along the mesh dimension
    ``dim``, as :func:`halo_exchange` takes them, made once per mesh (every
    rank makes every pair group, in one order), with the default group's
    collective timeout."""
    import torch.distributed as dist

    from tikejax_torch.parallel._ranks import group_timeout

    cache = mesh.__dict__.setdefault("_tikejax_groups", {})
    key = ("pairs", dim)
    if key not in cache:
        names = mesh.mesh_dim_names
        at = names.index(dim)
        layout = mesh.mesh.movedim(at, -1)
        lines = layout.reshape(-1, layout.shape[-1]).tolist()
        me = dist.get_rank()
        mine = []
        for line in lines:
            for d in range(len(line) - 1):
                lo, hi = line[d], line[d + 1]
                group = dist.new_group([lo, hi], timeout=group_timeout())
                if me in (lo, hi):
                    mine.append((d, group, lo, hi))
        cache[key] = sorted(mine, key=lambda pair: pair[0])
    return cache[key]


class _Comm:
    """Where a run on a mesh reduces (the JAX package's ``_scalar_axes``,
    ``_grad_prb_axes``, ``_dot`` and ``_halo_fix``): the process groups of
    the scan axis (``options.axis_name``), of the theta axis
    (``theta_axis_name``), of the object axis (``obj_axis_name``), of every
    rank (a mesh spans every rank), of the theta and object axes together
    (the object-domain inner products) and of the scan and object axes
    together (the probe-domain sums over positions); and the object axis'
    pair groups of the halo exchange. A dimension of one rank sums nothing,
    and without a mesh every reduction is the identity."""

    def __init__(self, o: CGOptions, mesh):
        names = tuple(a for a in (o.theta_axis_name, o.axis_name,
                                  o.obj_axis_name) if a is not None)
        if names and mesh is None:
            entry = ("run_tiled" if o.obj_axis_name is not None
                     else "run_sharded")
            raise ValueError(
                f"axis_name / theta_axis_name / obj_axis_name ({names}) "
                "name dimensions of a mesh: run through "
                f"tikejax_torch.parallel.{entry}")

        def size(name):
            return (1 if name is None
                    else mesh.size(mesh.mesh_dim_names.index(name)))

        def group(*dims):
            dims = tuple(d for d in dims if size(d) > 1)
            if not dims:
                return None
            if len(dims) == 1:
                return mesh.get_group(dims[0])
            return _mesh_groups(mesh, dims)

        self.scan = group(o.axis_name)
        self.theta = group(o.theta_axis_name)
        self.obj = group(o.obj_axis_name)
        # The halo rows are masked out of the inner products on any tiling
        # mesh, and exchanged where there are two slabs or more.
        self.halo = o.obj_halo if o.obj_axis_name is not None else 0
        self.pairs = (_halo_pairs(mesh, o.obj_axis_name)
                      if self.halo and self.obj is not None else [])
        if self.obj is None and (self.scan is None or self.theta is None):
            self.every = self.scan if self.scan is not None else self.theta
        else:
            import torch.distributed as dist

            self.every = dist.group.WORLD
        self.obj_theta = group(o.theta_axis_name, o.obj_axis_name)
        self.obj_scan = group(o.axis_name, o.obj_axis_name)

    @staticmethod
    def _sum(x, group):
        return x if group is None or x is None else all_reduce(x, group)

    def scalar(self, x):
        """A sum over the positions (an objective, a line-search value,
        sum(data)): over every rank."""
        return self._sum(x, self.every)

    def over_scan(self, x):
        """An object-domain sum over the positions (the object gradient,
        the illumination map): over the scan axis, then under object tiling
        the halo exchange over the object axis."""
        x = self._sum(x, self.scan)
        if x is not None and self.pairs:
            x = halo_exchange(x, self.pairs, self.halo)
        return x

    def over_positions(self, x):
        """A probe-domain sum over the positions (the probe gradient, the
        ``seen`` map): over the scan and object axes."""
        return self._sum(x, self.obj_scan)

    def max_over_obj(self, x):
        """The maximum over the object axis (the illumination map's
        per-angle maximum under object tiling)."""
        return x if self.obj is None else all_reduce(x, self.obj, op="max")

    def owned(self, x):
        """The owned rows of an object-domain array: the halo rows mirror
        the next slab's and must not count twice in an inner product."""
        return x[:, :x.shape[1] - self.halo] if self.halo else x

    def over_theta(self, x, kind="psi"):
        """A sum over the angles of inner products of object-domain
        (``kind='psi'``, also over the object axis) or probe-domain
        (``'prb'``) arrays."""
        return self._sum(x, self.obj_theta if kind == "psi" else self.theta)


def _lbfgs_memory(direction: str) -> int:
    """Ring size for direction='lbfgs[:m]'; 0 for 'dy'/'auto'."""
    if direction in ("dy", "auto"):
        return 0
    base, _, depth = direction.partition(":")
    if base != "lbfgs" or (depth and not depth.isdigit()):
        raise ValueError(f"unknown direction {direction!r}; "
                         "expected 'auto', 'dy', 'lbfgs', or "
                         "'lbfgs:<m>'")
    m = int(depth) if depth else 8
    if not 1 <= m <= 32:
        raise ValueError(f"lbfgs memory must be in [1, 32], got {m}")
    return m


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty(0, dtype=dtype).real.dtype


def zero_cg_state(psi: torch.Tensor, options: CGOptions) -> tuple:
    """All-zeros carry matching metrics['cg_state'] for these options.

    An all-zeros state is exactly what :func:`run_impl` starts from with
    ``cg_init=None`` (a steepest-descent start; an empty count=0 L-BFGS
    ring), so a caller may pass it to express 'restart fresh'."""
    rdt = _real_dtype(psi.dtype)
    zc = torch.zeros_like(psi)
    state = (zc, zc, torch.zeros((), dtype=rdt), torch.zeros((), dtype=rdt))
    m = _lbfgs_memory(options.direction) if options.carry_lbfgs else 0
    if m:
        ring = torch.zeros((m,) + tuple(psi.shape), dtype=psi.dtype,
                           device=psi.device)
        state += (ring, ring, torch.zeros(m, dtype=rdt),
                  torch.zeros((), dtype=torch.int32))
    return state


def _rdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real inner product of complex arrays viewed as real vectors."""
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def _quad_stats(fpsi, fd):
    """Per-pixel quadratic coefficients of |fpsi + gamma*fd|^2 summed over
    modes: (a, b, c) of shape (ntheta, nscan, nd, nd), computed over
    chunks of positions so that no farplane-sized temporary is allocated
    beside them."""
    t, s, _, nd, _ = fpsi.shape
    a, b, c = (torch.empty((t, s, nd, nd), dtype=fpsi.real.dtype,
                           device=fpsi.device) for _ in range(3))
    for ac, bc, cc, fp, d in _position_chunks((a, b, c, fpsi, fd),
                                              16 * 2**20):
        ac.copy_(likelihoods.total_intensity(fp))
        bc.copy_(torch.sum((torch.conj(fp) * d).real, dim=2))
        cc.copy_(likelihoods.total_intensity(d))
    return a, b, c


def _direction_pair(psi, prb, dpsi, dprb):
    """(object, probe) whose farplane is the direction's: G is linear in
    each, so the object direction is (dpsi, prb), the probe direction
    (psi, dprb)."""
    return (dpsi, prb) if dpsi is not None else (psi, dprb)


def _minf_of_gamma(model, a, b, c, data, gamma):
    """Objective at psi + gamma*d from quadratic statistics."""
    intensity = torch.clamp_min(a + 2.0 * gamma * b + gamma * gamma * c, 0.0)
    d = torch.clamp_min(data, 0.0)
    if model == "gaussian":
        amp = torch.sqrt(intensity + 1e-12)
        return torch.sum((amp - torch.sqrt(d))**2)
    return torch.sum(intensity - d * torch.log(intensity + 1e-8))


class _Lbfgs:
    """The L-BFGS memory, kept in place: S/Y rings of m object-shaped
    device arrays allocated once and written slot by slot (``head`` is the
    slot of the oldest pair, where the next push goes), and on the host the
    curvature products ``sy`` by slot, the number of valid pairs and the
    float64 Gram matrix of the ring by slot (rows and columns S_0..S_{m-1},
    Y_0..Y_{m-1})."""

    def __init__(self, S: torch.Tensor, Y: torch.Tensor, sy: list[float],
                 count: int):
        m = S.shape[0]
        self.S, self.Y, self.sy, self.count = S, Y, sy, count
        self.head = 0
        self.gram = [[0.0] * (2 * m) for _ in range(2 * m)]

    def slot(self, i: int) -> int:
        """The slot of pair ``i`` in age order (0 the oldest, m-1 the
        newest)."""
        return (self.head + i) % self.S.shape[0]

    def export(self, real_dtype) -> tuple:
        """(S, Y, sy, count) in the JAX package's layout: oldest first,
        newest at index m-1."""
        m, h = self.S.shape[0], self.head
        order = [self.slot(i) for i in range(m)]
        S, Y = ((self.S, self.Y) if h == 0 else
                (torch.roll(self.S, -h, 0), torch.roll(self.Y, -h, 0)))
        return (S, Y, torch.tensor([self.sy[k] for k in order],
                                   dtype=real_dtype),
                torch.tensor(self.count, dtype=torch.int32))


class _Engine:
    """Geometry/options-bound internals of the CG loop; counts the host
    reads it makes in ``syncs`` (:meth:`host`, each a ``cg.host_read``
    span) and its objective evaluations (gradient passes and line-search
    candidates) in ``evaluations`` (:meth:`evaluation`, each a
    ``cg.grad_pass`` or ``cg.minf_pass`` span)."""

    def __init__(self, g: Geometry, o: CGOptions, backend: str,
                 f_base=None, mesh=None):
        if o.nchunks < 1 or g.nscan % o.nchunks:
            raise ValueError(
                f"nchunks ({o.nchunks}) must divide nscan ({g.nscan})")
        if o.model not in likelihoods.MODELS:
            raise ValueError(f"unknown model {o.model!r}")
        if o.precondition not in ("illum", "illum_lowk", "max", "none"):
            raise ValueError(f"unknown precondition {o.precondition!r}; "
                             "expected 'illum', 'illum_lowk', 'max', or "
                             "'none'")
        if o.precondition == "illum_lowk":
            if o.recover_prb:
                raise ValueError("precondition='illum_lowk' is "
                                 "object-only (the low-k filter has no "
                                 "probe analogue); run joint recovery "
                                 "with 'illum' first")
            if o.obj_axis_name is not None:
                raise ValueError("precondition='illum_lowk' needs the "
                                 "full object spectrum; it does not "
                                 "compose with object-domain tiling")
            if o.lowk_boost < 0 or not (0 < o.lowk_frac <= 0.5):
                raise ValueError("lowk_boost must be >= 0 and lowk_frac "
                                 "in (0, 0.5]")
        if o.memory not in ("auto", "materialized", "frameless"):
            raise ValueError(f"unknown memory policy {o.memory!r}")
        if o.linesearch not in ("auto", "interp", "backtracking",
                                "parabolic"):
            raise ValueError(f"unknown linesearch {o.linesearch!r}; "
                             "expected 'auto', 'interp', 'backtracking',"
                             " or 'parabolic'")
        if o.merged_linesearch not in ("auto", "off"):
            raise ValueError(f"unknown merged_linesearch "
                             f"{o.merged_linesearch!r}; expected 'auto' "
                             "or 'off'")
        self.lbfgs_m = _lbfgs_memory(o.direction)
        if o.step_policy not in ("auto", "track", "regrow"):
            raise ValueError(f"unknown step_policy {o.step_policy!r}; "
                             "expected 'auto', 'track', or 'regrow'")
        if o.target_residual < 0:
            raise ValueError("target_residual must be >= 0")
        if o.step_growth < 1.0:
            raise ValueError("step_growth must be >= 1 (the warm start "
                             "may only regrow toward step0)")
        if o.stop_on_stall < 0:
            raise ValueError("stop_on_stall must be >= 0")
        diffraction._check_kernel(o.kernel)
        self.kernel = diffraction.resolve_kernel(o.kernel, backend)
        self.fused = self.kernel.startswith("fused")
        self.ls = o.linesearch
        if self.ls == "auto":
            deep = self.kernel in ("fused_mp", "fused_hp", "fused_mx",
                                   "fused_hx")
            self.ls = "backtracking" if deep else "interp"
        # 'auto' is frameless on the fused tiers; 'xla' and 'pallas' have
        # no frameless path.
        self.frameless = o.memory == "frameless" or (o.memory == "auto"
                                                     and self.fused)
        self.merged = (o.merged_linesearch == "auto" and self.frameless
                       and o.nchunks == 1 and not o.recover_prb
                       and self.ls in ("backtracking", "interp")
                       and not o.fused_linesearch and self.fused)
        # The one-pass line search needs both farplanes in memory.
        self.fused_linesearch = (o.fused_linesearch and o.nchunks == 1
                                 and not self.frameless and self.fused)
        check_slabs(o, backend)
        # Split-operator mode: psi is a small correction on a frozen base
        # whose farplane f_base was computed once with an accurate kernel.
        if f_base is not None and self.frameless and not self.fused:
            raise ValueError("frameless split-operator mode needs the "
                             "fused kernels")
        if f_base is not None and o.recover_prb:
            raise ValueError("split-operator mode (f_base) does not "
                             "support joint probe recovery; rebase "
                             "the probe between segments instead")
        self.f_base = f_base
        self.g = g
        self.o = o
        self.minf_fn, self.resid_fn = likelihoods.get_model(o.model)
        self.precision = diffraction._fused_precision(self.kernel)
        self.comm = _Comm(o, mesh)
        self.syncs = 0
        self.evaluations = 0

    def host(self, x: torch.Tensor, read=float):
        """Read the device value ``x`` on the host with ``read`` (a scalar
        with ``float``; several at once with ``torch.Tensor.tolist``): one
        synchronisation, counted in ``syncs`` and spanned as
        ``cg.host_read``. Every host read of the loop comes through
        here."""
        self.syncs += 1
        with span("cg.host_read"):
            return read(x)

    def evaluation(self, name: str):
        """The span of one objective evaluation, ``'cg.grad_pass'`` or
        ``'cg.minf_pass'``, counted in ``evaluations``."""
        self.evaluations += 1
        return span(name)

    def dots(self, *pairs, kind: str = "psi") -> torch.Tensor:
        """The real inner products ``<a, b>`` of the object-domain
        (``kind='psi'``) or probe-domain (``'prb'``) ``pairs``, stacked on
        the device and summed over the mesh in one collective (the JAX
        package's ``_dot``): object-domain arrays over the theta and object
        axes, on their owned rows only; probe-domain ones over the theta
        axis."""
        own = self.comm.owned if kind == "psi" else (lambda x: x)
        return self.comm.over_theta(torch.stack(
            [_rdot(own(a), own(b)) for a, b in pairs]), kind)

    def dot(self, a, b, kind: str = "psi") -> torch.Tensor:
        return self.dots((a, b), kind=kind)[0]

    # -- objective and gradient passes ----------------------------------

    def _fwd(self, psi, scan, prb):
        return diffraction.fwd_raw(psi, scan, prb, self.g.ndet, self.kernel)

    def _chunks(self, scan, data):
        """(scan, data, base or None) of each chunk of positions, in
        order: chunk c holds positions [c*s/k, (c+1)*s/k) of every angle,
        as the JAX package's ``_chunked``."""
        k = self.o.nchunks
        step = scan.shape[1] // k
        base = (None if self.f_base is None
                else fused._base_complex(self.f_base))

        def part(a, c):
            return None if a is None else a[:, c * step:(c + 1) * step]

        return [(part(scan, c), part(data, c), part(base, c))
                for c in range(k)]

    def grad_pass(self, psi, prb, scan, scan_i, data, want_psi=True,
                  want_prb=False):
        """(minf, raw object gradient, raw probe gradient, farplane or
        None) at ``psi``: the gradients not asked for are None. On the
        fused tiers, unstreamed: frameless, one ``grad_fused`` or
        ``grad_prb_fused`` pass; materialized, the object gradient is the
        farplane ``G psi + base`` (one ``fwd`` pass with the base epilogue)
        and one ``adj_residual`` pass over it. Otherwise the operators,
        summed over the chunks in order (the JAX package's ``lax.scan``)
        with one chunk's farplane at a time. Unstreamed and materialized,
        the farplane is returned for the line search to reuse."""
        with self.evaluation("cg.grad_pass"):
            o = self.o
            if self.fused and o.nchunks == 1:
                adj_precision = diffraction._fused_adj_precision(self.kernel)
                if not want_prb and self.frameless:
                    grad, f0 = fused.grad_fused(
                        psi, data, scan_i, prb, self.g.ndet, o.model,
                        precision=self.precision, adj_precision=adj_precision,
                        base=self.f_base)
                    return self._reduced(f0, grad, None, None)
                if not want_prb:
                    fpsi = fused.fwd(psi, scan_i, prb, self.g.ndet,
                                     precision=self.precision,
                                     base=self.f_base)
                    grad, f0 = fused.adj_residual(
                        fpsi, data, scan_i, prb, self.g.nz, self.g.n, o.model,
                        precision=adj_precision)
                    return self._reduced(f0, grad, None, fpsi)
                if self.frameless:
                    gprb, f0 = fused.grad_prb_fused(
                        psi, data, scan_i, prb, self.g.ndet, o.model,
                        precision=self.precision, adj_precision=adj_precision)
                    return self._reduced(f0, None, gprb, None)
            f0 = torch.zeros((), dtype=psi.real.dtype, device=psi.device)
            gpsi = torch.zeros_like(psi) if want_psi else None
            gprb = torch.zeros_like(prb) if want_prb else None
            fpsi = None
            for sc, dc, fb in self._chunks(scan, data):
                fp = self._fwd(psi, sc, prb)
                if fb is not None:
                    fp = fp + fb
                # Over chunks of positions: no data-sized temporary beside the
                # farplane and its residual.
                f0 = f0 + _sum_over_positions(self.minf_fn, fp, dc)
                r = _map_over_positions(self.resid_fn, fp, dc)
                if o.nchunks == 1:
                    fpsi = fp
                del fp  # streamed: one chunk's farplane at a time
                if want_psi:
                    gpsi = gpsi + diffraction.adj_raw(r, sc, prb, self.g.nz,
                                                      self.g.n, self.kernel)
                if want_prb:
                    gprb = gprb + diffraction.adj_probe_raw(r, sc, psi,
                                                            self.g.nprb,
                                                            self.kernel)
                del r
            return self._reduced(f0, gpsi, gprb, fpsi)

    def _reduced(self, f0, gpsi, gprb, fpsi):
        """A gradient pass's results summed over the mesh where the JAX
        package ``psum``s them: the objective over every rank, the object
        gradient over the scan axis (then the halo exchange), the probe
        gradient over the scan and object axes."""
        return (self.comm.scalar(f0), self.comm.over_scan(gpsi),
                self.comm.over_positions(gprb), fpsi)

    def minf_pass(self, psi, prb, scan_i, data):
        """The objective at ``psi`` (plus the base) through the frameless
        ``minf_fused`` kernel: one candidate of the non-merged line
        search."""
        with self.evaluation("cg.minf_pass"):
            return self.comm.scalar(fused.minf_fused(
                psi, data, scan_i, prb, self.g.ndet, self.o.model,
                precision=self.precision, base=self.f_base))

    def line_fn(self, psi, prb, scan, scan_i, data, fpsi, dpsi=None,
                dprb=None):
        """``f_of(gamma)`` -> (objective on the host, None) along the
        object direction ``dpsi`` or the probe direction ``dprb``: one
        ``minf_fused`` pass per candidate on the frameless fused path;
        else the quadratic statistics of the farplane ``fpsi`` (or of every
        chunk's, streamed) and of the direction's farplane, computed here
        once (materialized on a fused tier, by one ``fwd_quad_stats``
        pass) and evaluated per candidate over chunks of positions."""
        o = self.o
        if self.fused and o.nchunks == 1 and self.frameless:
            if dpsi is not None:
                def f_of(gamma):
                    return self.host(self.minf_pass(psi + gamma * dpsi, prb,
                                                    scan_i, data)), None
            else:
                def f_of(gamma):
                    return self.host(self.minf_pass(psi, prb + gamma * dprb,
                                                    scan_i, data)), None
            return f_of

        x, p = _direction_pair(psi, prb, dpsi, dprb)
        if self.fused and o.nchunks == 1:
            stats = [(fused.fwd_quad_stats(x, scan_i, p, fpsi,
                                           precision=self.precision), data)]
        elif o.nchunks == 1:
            stats = [(_quad_stats(fpsi, self._fwd(x, scan, p)), data)]
        else:
            stats = []
            for sc, dc, fb in self._chunks(scan, data):
                fp = self._fwd(psi, sc, prb)
                if fb is not None:
                    fp = fp + fb
                stats.append((_quad_stats(fp, self._fwd(x, sc, p)), dc))
                del fp

        def f_of(gamma):
            with self.evaluation("cg.minf_pass"):
                minf_at = functools.partial(_minf_of_gamma, o.model,
                                            gamma=gamma)
                total = self.comm.scalar(sum(
                    _sum_over_positions(minf_at, a, b, c, dc)
                    for (a, b, c), dc in stats))
            return self.host(total), None

        return f_of

    def searcher(self, psi, prb, scan, scan_i, data, fpsi, dpsi=None,
                 dprb=None):
        """``search(f0, gamma0, fp0)`` -> the accepted step along the object
        direction ``dpsi`` or the probe direction ``dprb``: the fused
        one-pass search (:meth:`line_search_all`) on the direction's
        farplane and ``fpsi`` when it applies, else :meth:`line_search`
        over :meth:`line_fn`. The closure holds what the search reads (the
        statistics, or both farplanes), so the caller may drop ``fpsi``."""
        if self.fused_linesearch:
            x, p = _direction_pair(psi, prb, dpsi, dprb)
            fd = self._fwd(x, scan_i, p)
            return lambda f0, gamma0, fp0: self.line_search_all(
                fpsi, fd, data, f0, gamma0)
        f_of = self.line_fn(psi, prb, scan, scan_i, data, fpsi, dpsi, dprb)
        return lambda f0, gamma0, fp0: self.line_search(f_of, f0, gamma0,
                                                        fp0)[0]

    def line_search_all(self, fpsi, fd, data, f0, gamma0):
        """One-pass line search: the objectives of the whole backtracking
        candidate set {gamma0 * shrink^k, k = 0..max_halvings} (float32, as
        in the JAX package) from one ``ls_objectives`` pass over the two
        farplanes and the data, read on the host at once; the first step
        whose objective does not exceed ``f0`` wins, gamma = 0 if none
        does. Counts one evaluation and one host read."""
        o = self.o
        f32 = torch.float32
        gammas = torch.tensor(gamma0, dtype=f32) * torch.tensor(
            o.step_shrink, dtype=f32) ** torch.arange(o.max_halvings + 1,
                                                       dtype=f32)
        with self.evaluation("cg.minf_pass"):
            values = self.comm.scalar(linesearch.ls_objectives(
                fpsi, fd, data, gammas, o.model))
        values = self.host(values, torch.Tensor.tolist)
        for gamma, f in zip(gammas.tolist(), values):
            if f <= f0:
                return gamma
        return 0.0

    # -- step control ----------------------------------------------------

    def gamma0(self, gamma_prev: float, gamma0_prev: float) -> float:
        """Warm start: ``gamma_prev`` is the last ACCEPTED step (0 on
        failure), ``gamma0_prev`` the start used last iteration."""
        o = self.o
        if not o.adaptive_step:
            return o.step0
        if o.step_policy in ("auto", "regrow"):
            if gamma_prev > 0:
                return min(o.step0, o.step_growth * gamma_prev)
            return o.step0
        if gamma_prev > 0:
            grown = (o.step_growth * gamma_prev
                     if gamma_prev >= gamma0_prev else gamma_prev)
            return min(o.step0, grown)
        return gamma0_prev if gamma0_prev > 0 else o.step0

    def lbfgs_gamma0(self, count: int, gamma_prev: float,
                     gamma0_prev: float) -> float:
        """Line-search start for the L-BFGS direction: the natural step 1
        once history exists ('track': the previous accepted step after a
        backtrack, ceiling 1); the Dai-Yuan warm start without history."""
        if count <= 0:
            return self.gamma0(gamma_prev, gamma0_prev)
        if self.o.step_policy == "track" and 0 < gamma_prev < gamma0_prev:
            return min(1.0, gamma_prev)
        return 1.0

    def interp_gamma(self, gamma0, f0, fg0, fp0):
        """Safeguarded quadratic-interpolation candidate after the first
        candidate was rejected, clipped to [shrink^2, shrink] * gamma0."""
        o = self.o
        denom = fg0 - f0 - fp0 * gamma0
        if denom > 0 and fp0 < 0:
            gi = -fp0 * gamma0 * gamma0 / (2.0 * denom)
        else:
            gi = gamma0 * o.step_shrink
        lo = o.step_shrink * o.step_shrink * gamma0
        return min(max(gi, lo), o.step_shrink * gamma0)

    def line_search(self, f_of, f0, gamma0, fp0):
        """Largest gamma in {gamma0 * shrink^k} with f(gamma) <= f0 (the
        first halving replaced by the interpolation step under 'interp');
        gamma = 0 if none within max_halvings. ``f_of(gamma)`` returns
        (objective on the host, payload); ``fp0()`` the directional
        derivative on the host. Returns (gamma, f, payload) with f and
        payload of the last backtracking candidate evaluated; under
        'parabolic' gamma is the refined step."""
        o = self.o
        gamma = gamma0
        fg, payload = f_of(gamma)
        k = 0
        if self.ls == "interp" and o.max_halvings > 0 and fg > f0:
            gamma = self.interp_gamma(gamma0, f0, fg, fp0())
            fg, payload = f_of(gamma)
            k = 1
        while fg > f0 and k < o.max_halvings:
            gamma = gamma * o.step_shrink
            fg, payload = f_of(gamma)
            k += 1
        gamma = gamma if fg <= f0 else 0.0
        if self.ls == "parabolic":
            gamma = self.parabolic_refine(f_of, f0, gamma, fg)
        return gamma, fg, payload

    def parabolic_refine(self, f_of, f0, gamma, fg):
        """Refine an accepted backtracking step to the vertex of the
        parabola through (0, f0), (gamma/2, fm), (gamma, fg), clipped to
        [gamma/8, 2 gamma]: the best of the three sampled steps, taken only
        when it does not exceed ``fg``, so the search stays monotone. A
        rejected search (gamma = 0) and a parabola without positive
        curvature pass through untouched. Each extra sample is one
        evaluation and one host read (the JAX package evaluates both in
        every case, inside its jit; the accepted step is the same)."""
        if not gamma > 0:
            return gamma
        fm, _ = f_of(0.5 * gamma)
        curv = f0 - 2.0 * fm + fg  # = f'' gamma^2 / 2
        if not curv > 0:
            return gamma
        vertex = 0.25 * gamma * (3.0 * f0 + fg - 4.0 * fm) / curv
        vertex = min(max(vertex, 0.125 * gamma), 2.0 * gamma)
        fv, _ = f_of(vertex)
        # The first of the smallest, as argmin over (fg, fm, fv).
        f_best, g_best = fg, gamma
        for f, g in ((fm, 0.5 * gamma), (fv, vertex)):
            if f < f_best:
                f_best, g_best = f, g
        return g_best

    # -- search directions -----------------------------------------------

    def dy_direction(self, grad, grad_prev, d_prev, kind="psi"):
        """d = -g + beta * d_prev, beta = ||g||^2 / <d_prev, g - g_prev>_R
        (Dai-Yuan 1999); steepest descent when the denominator is 0. The
        products are global (:meth:`dots` of ``kind``)."""
        num, den = self.dots((grad, grad), (d_prev, grad - grad_prev),
                             kind=kind)
        beta = torch.where(den != 0, num / torch.where(den != 0, den, 1.0),
                           0.0)
        return -grad + beta.to(grad.dtype) * d_prev

    def lbfgs_init(self, like: torch.Tensor, carried=None) -> _Lbfgs:
        """The ring for arrays like ``like``: empty, or a copy of the
        ``carried`` (S, Y, sy, count) in the JAX package's layout, whose
        Gram matrix one float64 matrix product makes on the device and one
        host read brings (once a run)."""
        m = self.lbfgs_m
        alloc = torch.zeros if carried is None else torch.empty
        S, Y = (alloc((m,) + tuple(like.shape), dtype=like.dtype,
                      device=like.device) for _ in range(2))
        if carried is None:
            return _Lbfgs(S, Y, [0.0] * m, 0)
        cS, cY, sy, count = carried
        if cS.shape[0] != m:
            raise ValueError(f"carried L-BFGS ring has m={cS.shape[0]}, "
                             f"options request m={m}")
        S.copy_(torch.as_tensor(cS))
        Y.copy_(torch.as_tensor(cY))
        lb = _Lbfgs(S, Y, torch.as_tensor(sy).detach().to(
            "cpu", torch.float64).tolist(), int(count))
        if lb.count > 0:
            rows = S.shape[-2] - self.comm.halo
            ring = torch.view_as_real(torch.cat([S, Y])[..., :rows, :])
            ring = ring.reshape(2 * m, -1).to(torch.float64)
            lb.gram = self.host(self.comm.over_theta(ring @ ring.T),
                                torch.Tensor.tolist)
        return lb

    def lbfgs_direction(self, lb: _Lbfgs, grad, grad_prev, d_prev,
                        gamma_prev: float) -> torch.Tensor:
        """Push the pair (s, y) = (gamma_prev d_prev, grad - grad_prev) when
        the previous step was accepted and the pair passes the curvature
        guard <s,y> > 1e-12 ||s|| ||y||, then the two-loop recursion on the
        (already preconditioned) gradient over the valid pairs; H0 =
        (<s,y>/<y,y>) I from the newest pair scales the direction so the
        natural step is 1. With no pairs this is steepest descent.

        The compact form of the two-loop: one ``lbfgs_gram`` pass makes
        every inner product the push and the recursion need, summed over
        the mesh in one collective and read in ONE host read; the host
        keeps the ring's Gram matrix, runs the recursion on scalars in
        float64 and one ``lbfgs_combine`` pass stores the pair and writes
        d = -(h0 g + sum_i (alpha_i - beta_i) s_i - h0 alpha_i y_i). Without
        a push to test and without pairs, d = -g with no read."""
        m = self.lbfgs_m
        accepted = gamma_prev > 0
        zero = [0.0] * m
        if not accepted and lb.count == 0:
            return lbfgs.lbfgs_combine(lb.S, lb.Y, grad, None, None, 0.0, -1,
                                       1.0, zero, zero)
        prods = lbfgs.lbfgs_gram(lb.S, lb.Y, grad, grad_prev, d_prev,
                                 gamma_prev, grad.shape[-2] - self.comm.halo)
        vals = self.host(self.comm.over_theta(prods.reshape(-1)),
                         torch.Tensor.tolist)
        G = lb.gram
        n = 2 * m + 3
        pg, ps, py = vals[:n], vals[n:2 * n], vals[2 * n:]
        gS, gY = pg[:m], pg[m:2 * m]
        slot = -1
        if accepted:
            sy, ss, yy = ps[2 * m + 2], ps[2 * m + 1], py[2 * m + 2]
            if sy > 1e-12 * math.sqrt(ss * yy):
                slot = lb.head
                for j in range(2 * m):
                    if j % m != slot:
                        G[slot][j] = G[j][slot] = ps[j]
                        G[m + slot][j] = G[j][m + slot] = py[j]
                G[slot][slot], G[m + slot][m + slot] = ss, yy
                G[slot][m + slot] = G[m + slot][slot] = sy
                gS[slot], gY[slot] = pg[2 * m + 1], pg[2 * m + 2]
                lb.sy[slot] = sy
                lb.head = (slot + 1) % m
                lb.count = min(lb.count + 1, m)
        c_g, a, b = _lbfgs_coefficients(lb, gS, gY)
        return lbfgs.lbfgs_combine(lb.S, lb.Y, grad, grad_prev, d_prev,
                                   gamma_prev, slot, c_g, a, b)

    def keep_going(self, i: int, residual: list, gamma: list,
                   gamma_prb: list) -> bool:
        """The JAX package's loop condition, on the host metrics: a stall
        is an iteration in which neither the object nor the probe moved."""
        o = self.o
        if i >= o.piter:
            return False
        if o.target_residual > 0 and i > 0 and not (
                residual[i - 1] > o.target_residual):
            return False
        n = o.stop_on_stall
        return not (n > 0 and i >= n and all(
            g == 0 and gp == 0
            for g, gp in zip(gamma[i - n:i], gamma_prb[i - n:i])))


def _lbfgs_coefficients(lb: _Lbfgs, gS: list, gY: list):
    """(c_g, a, b) of the L-BFGS direction d = -(c_g g + sum_k a[k] S_k +
    b[k] Y_k), by slot: the two-loop recursion run on scalars in float64,
    from the ring's Gram matrix and the products ``gS[k] = <S_k, g>``,
    ``gY[k] = <Y_k, g>``. With pairs i (oldest first), rho_i = 1 / <s_i,
    y_i> (0 where that is not positive):

      alpha_i = rho_i (<s_i, g> - sum_{j>i} alpha_j <s_i, y_j>)
      h0      = <s, y> / <y, y> of the newest pair (1 where <y, y> is 0)
      beta_i  = rho_i (h0 (<y_i, g> - sum_j alpha_j <y_i, y_j>)
                       + sum_{k<i} (alpha_k - beta_k) <y_i, s_k>)
      d       = -(h0 g - h0 sum_j alpha_j y_j + sum_i (alpha_i - beta_i) s_i)

    which is what the two loops compute on arrays. Slots of no valid pair
    get 0; with no pairs d = -g."""
    m = len(gS)
    a, b = [0.0] * m, [0.0] * m
    if lb.count == 0:
        return 1.0, a, b
    G = lb.gram
    valid = [lb.slot(i) for i in range(m - lb.count, m)]
    rho = {k: 1.0 / max(lb.sy[k], 1e-300) if lb.sy[k] > 0 else 0.0
           for k in valid}
    alpha = {}
    for i in reversed(range(len(valid))):
        k = valid[i]
        alpha[k] = rho[k] * (gS[k] - sum(alpha[j] * G[k][m + j]
                                         for j in valid[i + 1:]))
    newest = valid[-1]
    yy = G[m + newest][m + newest]
    h0 = lb.sy[newest] / max(yy, 1e-300) if yy > 0 else 1.0
    beta = {}
    for i, k in enumerate(valid):
        q = gY[k] - sum(alpha[j] * G[m + k][m + j] for j in valid)
        beta[k] = rho[k] * (h0 * q + sum((alpha[j] - beta[j]) * G[m + k][j]
                                         for j in valid[:i]))
    for k in valid:
        a[k] = alpha[k] - beta[k]
        b[k] = -h0 * alpha[k]
    return h0, a, b


def _sum_over_positions(fn, *arrays, chunk_bytes=16 * 2**20):
    """``sum(fn(*chunks))`` over chunks of scan positions (axis 1) of
    ``arrays``, so that no data-sized temporary is allocated (the data are
    the largest array of the problem: 1 GiB at 16384 frames of 128^2; a
    few chunk-sized temporaries stay far below the joint path's 256 MiB
    of working memory at 4096 frames)."""
    return sum(fn(*chunks) for chunks in _position_chunks(arrays,
                                                          chunk_bytes))


def _map_over_positions(fn, far, data, chunk_bytes=16 * 2**20):
    """``fn(far, data)`` for a farplane-shaped result, computed over chunks
    of scan positions into one output, so that no data-sized temporary is
    allocated beside it (see :func:`_sum_over_positions`)."""
    out = torch.empty_like(far)
    for o, f, d in _position_chunks((out, far, data), chunk_bytes):
        o.copy_(fn(f, d))
    return out


def _position_chunks(arrays, chunk_bytes):
    """Matching chunks of scan positions (axis 1) of ``arrays``, each
    chunk of the largest array about ``chunk_bytes``."""
    frame_bytes = max(a.shape[0] * a[0, 0].numel() * a.element_size()
                      for a in arrays)
    step = max(1, chunk_bytes // frame_bytes)
    return zip(*(a.split(step, dim=1) for a in arrays))


def _probe_power(prb):
    return torch.sum(prb.real**2 + prb.imag**2, dim=1)  # (t, nprb, nprb)


def _lowk_symbol(nz, n, boost, frac, dtype, device):
    """Real positive Fourier symbol 1 + boost * k0^2 / (k0^2 + |k|^2) with
    k0 = frac * Nyquist, ``(nz, n)``: self-adjoint and positive-definite as
    a real-linear operator, so a valid CG preconditioner factor."""
    fy = torch.fft.fftfreq(nz, dtype=dtype, device=device)[:, None]
    fx = torch.fft.fftfreq(n, dtype=dtype, device=device)[None, :]
    k02 = (0.5 * frac) ** 2
    return 1.0 + boost * k02 / (k02 + fy**2 + fx**2)


def _illum_denominator(prb, scan_i, nz, n, comm=None):
    """The probe-illumination map (on a mesh summed over the scan axis,
    then through the halo exchange), floored at 10% of its per-angle
    maximum (under object tiling the maximum over every slab)."""
    illum = _patches.illumination_map(scan_i, _probe_power(prb), nz, n)
    if comm is not None:
        illum = comm.over_scan(illum)
    m = torch.amax(illum, dim=(-2, -1), keepdim=True)
    if comm is not None:
        m = comm.max_over_obj(m)
    return torch.maximum(illum, 0.1 * m)


def _preconditioner(o: CGOptions, prb0, scan_i, nz, n, comm=None):
    """``precond(g, prb)``, the object-gradient preconditioner at the
    probe ``prb``. For 'illum' without recover_prb the denominator is
    computed once (the probe does not move); with it, it follows the
    current probe, as in the JAX package. 'illum_lowk' (object-only)
    multiplies the spectrum of the 'illum' result by :func:`_lowk_symbol`:
    two 2-D FFTs of the object per application. On a mesh the
    illumination map is summed over the scan axis (``comm``)."""
    if o.precondition == "illum_lowk":
        denom = _illum_denominator(prb0, scan_i, nz, n, comm)
        lowk = _lowk_symbol(nz, n, o.lowk_boost, o.lowk_frac,
                            prb0.real.dtype, prb0.device)
        return lambda g, prb: torch.fft.ifft2(torch.fft.fft2(g / denom)
                                              * lowk)
    if o.precondition == "illum":
        if not o.recover_prb:
            denom = _illum_denominator(prb0, scan_i, nz, n, comm)
            return lambda g, prb: g / denom
        return lambda g, prb: g / _illum_denominator(prb, scan_i, nz, n,
                                                     comm)
    if o.precondition == "max":
        def precond(g, prb):
            pmax = torch.amax(_probe_power(prb), dim=(-2, -1))
            return g * (1.0 / torch.clamp_min(pmax, 1e-32))[:, None, None]
        return precond
    return lambda g, prb: g


def _probe_preconditioner(o: CGOptions, scan_i, comm=None):
    """``precond(gprb, psi)``, the probe-gradient preconditioner: for
    'illum', divide by the object power each probe pixel sees over all
    positions (``patches.patch_power_map``, summed over the scan and object
    axes on a mesh), floored at 10% of its maximum; otherwise the
    identity."""
    if o.precondition != "illum":
        return lambda gprb, psi: gprb

    def precond(gprb, psi):
        seen = _patches.patch_power_map(scan_i, psi.abs()**2,
                                        gprb.shape[-1])
        if comm is not None:
            seen = comm.over_positions(seen)
        floor = 0.1 * torch.amax(seen, dim=(-2, -1), keepdim=True)
        return gprb / torch.maximum(seen, floor)[:, None]
    return precond


def _initial_state(eng: _Engine, o: CGOptions, psi0, cg_init):
    """(d, g_prev, gamma_prev, gamma0_prev, L-BFGS memory or None) from
    ``cg_init`` (a carried metrics['cg_state']) or a fresh start."""
    if cg_init is None:
        lb = eng.lbfgs_init(psi0) if eng.lbfgs_m else None
        return torch.zeros_like(psi0), torch.zeros_like(psi0), 0.0, 0.0, lb
    ring_carry = bool(eng.lbfgs_m) and o.carry_lbfgs
    if ring_carry and len(cg_init) != 8:
        raise ValueError("carry_lbfgs expects the 8-tuple cg_state layout "
                         "(4 CG slots + the (S, Y, sy, count) ring); got "
                         f"{len(cg_init)} entries")
    if not ring_carry and len(cg_init) != 4:
        raise ValueError(
            "cg_init has an 8-entry (L-BFGS ring) layout but this run "
            "carries only the 4-tuple (d, g, gamma, gamma0) CG slots -- "
            "pass carry_lbfgs=True with an L-BFGS direction to consume the "
            f"ring, or feed the 4-tuple state (got {len(cg_init)} entries)")

    def like_psi(x):
        return torch.as_tensor(x).to(device=psi0.device, dtype=psi0.dtype)

    d_in, g_in, gam_in, gam0_in = cg_init[:4]
    lb = (eng.lbfgs_init(psi0, tuple(cg_init[4:]) if ring_carry else None)
          if eng.lbfgs_m else None)
    return like_psi(d_in), like_psi(g_in), float(gam_in), float(gam0_in), lb


@torch.no_grad()
def run_impl(geometry: Geometry, options: CGOptions, data, psi0, scan, prb0,
             f_base=None, cg_init=None, mesh=None):
    """The CG loop. Returns (psi, prb, metrics) like :func:`run`. With
    ``f_base`` psi0 is a small correction on a frozen base object whose
    farplane is ``f_base`` (complex, or its ``view_as_real`` (re, im)
    halves, as ``fused.fwd(split_out=True)`` returns); ``cg_init`` is a
    carried ``metrics['cg_state']`` taken at the same iterate. With
    ``options.axis_name`` / ``theta_axis_name`` set, ``mesh`` is the
    ``DeviceMesh`` that names them and the arrays are this rank's slice
    (``tikejax_torch.parallel.run_sharded`` sets all three).

    Spans: the call is ``cg.run``, its set-up ``cg.setup``, then each
    iteration ``cg.iteration``: the classic body's gradient pass, then
    ``cg.direction``, ``cg.line_search``, ``cg.update`` and, with
    recover_prb, ``cg.probe_step`` (the probe's own gradient pass,
    direction and line search)."""
    with span("cg.run"):
        return _run_loop(geometry, options, data, psi0, scan, prb0, f_base,
                         cg_init, mesh)


def _run_loop(geometry, o: CGOptions, data, psi0, scan, prb0, f_base,
              cg_init, mesh):
    """The body of :func:`run_impl`."""
    with span("cg.setup"):
        eng = _Engine(geometry, o, diffraction._backend(psi0.device),
                      f_base, mesh)
        comm = eng.comm
        real_dtype = psi0.real.dtype
        device = psi0.device
        scan_i = _patches.scan_to_int(scan)
        precond = _preconditioner(o, prb0, scan_i, geometry.nz, geometry.n,
                                  comm)
        precond_prb = _probe_preconditioner(o, scan_i, comm)

        sum_data = eng.host(comm.scalar(_sum_over_positions(
            lambda c: torch.sum(torch.clamp_min(c, 0.0)), data)))
        minf_offset = (eng.host(comm.scalar(_sum_over_positions(
            likelihoods.poisson_perfect_minf, data)))
            if o.model == "poisson" else 0.0)

        minf, residual, gamma_hist, gamma_prb, grad_norm = [], [], [], [], []
        psi, prb = psi0, prb0
        d, g_prev, gam_prev, gam0_prev, lb = _initial_state(eng, o, psi0,
                                                            cg_init)
        # The probe's own Dai-Yuan state (joint recovery only).
        d_prb, g_prb_prev = torch.zeros_like(prb0), torch.zeros_like(prb0)
        gam_p_prev = gam0_p_prev = 0.0
        if eng.merged:
            f_t, g_raw, _, _ = eng.grad_pass(psi0, prb0, scan, scan_i, data)
            f_cur = eng.host(f_t)
            g_cur = precond(g_raw, prb0)

    def residual_of(f):
        return math.sqrt(max(f - minf_offset, 0.0) / sum_data)

    def fp0():
        # Directional derivative along d: 2 Re<raw gradient, d> (the
        # preconditioner rescales the gradient, not the objective).
        return 2.0 * eng.host(eng.dot(g_raw, d))

    def direction(g_now):
        """The search direction at the gradient ``g_now`` and its
        line-search start; updates the L-BFGS memory."""
        with span("cg.direction"):
            if lb is None:
                return (eng.dy_direction(g_now, g_prev, d),
                        eng.gamma0(gam_prev, gam0_prev))
            return (eng.lbfgs_direction(lb, g_now, g_prev, d, gam_prev),
                    eng.lbfgs_gamma0(lb.count, gam_prev, gam0_prev))

    def record(gamma, gamma0, f_iter, g_iter):
        """The iteration's entries of the histories (``gamma_prb``'s
        follows the probe step) and the step control's memory."""
        nonlocal gam_prev, gam0_prev
        if lb is not None and gamma == 0.0:
            lb.count = 0  # a fully-failed search restarts from -grad
        minf.append(f_iter)
        residual.append(residual_of(f_iter))
        gamma_hist.append(gamma)
        grad_norm.append(torch.sqrt(eng.dot(g_iter, g_iter)))
        gam_prev, gam0_prev = gamma, gamma0

    i = 0
    while eng.keep_going(i, residual, gamma_hist, gamma_prb):
        with span("cg.iteration"):
            gamma_p = 0.0
            if eng.merged:
                # Every candidate is evaluated with its gradient; the
                # accepted one seeds the next iteration.
                d, gamma0 = direction(g_cur)

                def f_of(gamma):
                    fc, gc, _, _ = eng.grad_pass(psi + gamma * d, prb, scan,
                                                 scan_i, data)
                    return eng.host(fc), gc

                with span("cg.line_search"):
                    gamma, fc, gc = eng.line_search(f_of, f_cur, gamma0, fp0)
                with span("cg.update"):
                    f_iter, g_iter = f_cur, g_cur
                    g_prev = g_cur
                    if fc <= f_cur:
                        psi = psi + gamma * d
                        g_cur, g_raw, f_cur = precond(gc, prb), gc, fc
                    record(gamma, gamma0, f_iter, g_iter)
            else:
                # Object step.
                f_t, g_raw, _, fpsi = eng.grad_pass(psi, prb, scan, scan_i,
                                                    data)
                f_iter = eng.host(f_t)
                g_iter = precond(g_raw, prb)
                d, gamma0 = direction(g_iter)
                with span("cg.line_search"):
                    search = eng.searcher(psi, prb, scan, scan_i, data, fpsi,
                                          dpsi=d)
                    del fpsi
                    gamma = search(f_iter, gamma0, fp0)
                    del search  # the line-search statistics or farplanes
                with span("cg.update"):
                    if gamma != 0.0:
                        psi = psi + gamma * d
                    g_prev = g_iter
                    record(gamma, gamma0, f_iter, g_iter)
                if o.recover_prb:
                    # Probe step at the updated object: its gradient, a
                    # Dai-Yuan direction and a warm-started line search of
                    # its own (cg.py's joint body in the JAX package).
                    with span("cg.probe_step"):
                        f_t, _, gp_raw, fpsi = eng.grad_pass(
                            psi, prb, scan, scan_i, data, want_psi=False,
                            want_prb=True)
                        f_p = eng.host(f_t)
                        gp = precond_prb(gp_raw, psi)
                        with span("cg.direction"):
                            d_prb = eng.dy_direction(gp, g_prb_prev, d_prb,
                                                     kind="prb")
                            gamma0_p = eng.gamma0(gam_p_prev, gam0_p_prev)
                        with span("cg.line_search"):
                            search = eng.searcher(psi, prb, scan, scan_i,
                                                  data, fpsi, dprb=d_prb)
                            del fpsi
                            gamma_p = search(f_p, gamma0_p,
                                             lambda: 2.0 * eng.host(eng.dot(
                                                 gp_raw, d_prb, kind="prb")))
                            del search
                        if gamma_p != 0.0:
                            prb = prb + gamma_p * d_prb
                        g_prb_prev = gp
                        gam_p_prev, gam0_p_prev = gamma_p, gamma0_p
            gamma_prb.append(gamma_p)
            if o.verbose_every > 0 and i % o.verbose_every == 0:
                print(f"iter {i}: minf={f_iter:.6e} gamma={gamma:.4f}",
                      flush=True)
        i += 1

    def padded(values):
        out = torch.zeros(o.piter, dtype=real_dtype, device=device)
        out[:len(values)] = torch.as_tensor(values, dtype=real_dtype,
                                            device=device)
        return out

    metrics = {
        "minf": padded(minf),
        "residual": padded(residual),
        "gamma": padded(gamma_hist),
        "grad_norm": padded(torch.stack(grad_norm) if grad_norm else []),
        "gamma_prb": padded(gamma_prb),
        "iters_run": torch.tensor(i, dtype=torch.int32),
        "host_syncs": eng.syncs,
        "evaluations": eng.evaluations,
    }
    if o.carry_state:
        # The terminal CG carry: the last direction, the preconditioned
        # gradient that built it, the accepted step and its start (host
        # scalars), then the L-BFGS ring under carry_lbfgs.
        cs = (d, g_prev, torch.tensor(gam_prev, dtype=real_dtype),
              torch.tensor(gam0_prev, dtype=real_dtype))
        if lb is not None and o.carry_lbfgs:
            cs += lb.export(real_dtype)
        metrics["cg_state"] = cs
    return psi, prb, metrics


def normalize_options(options: CGOptions, backend: str) -> CGOptions:
    """Resolve 'auto' kernel selection against the residual target for
    tensors on ``backend`` ('cuda' or 'cpu'), and normalize flag
    interactions: carry_lbfgs extends the carried state, so it implies
    carry_state."""
    if options.kernel == "auto":
        k = diffraction.resolve_kernel_for_target(
            "auto", options.target_residual, backend)
        options = dataclasses.replace(options, kernel=k)
    if options.carry_lbfgs and not options.carry_state:
        options = dataclasses.replace(options, carry_state=True)
    return options


def run(data, psi0, scan, prb0, geometry: Geometry,
        options: CGOptions | None = None, f_base=None, cg_init=None, **kw):
    """Reconstruct the object (and with ``recover_prb`` the probe) from
    measured intensities.

    The port's counterpart of ``tikejax.solvers.run``; extra keyword
    arguments override CGOptions fields. The slab fields are validated as
    the JAX package validates them and change nothing (:class:`CGOptions`).
    ``f_base`` (split-operator mode) and ``cg_init`` (a carried
    ``metrics['cg_state']``; with recover_prb it carries the object's
    state only, as in the JAX package) as in :func:`run_impl`.

    ``axis_name`` / ``theta_axis_name`` need a mesh: run through
    ``tikejax_torch.parallel.run_sharded``.

    Returns:
      (psi, prb, metrics): metrics holds per-iteration arrays {'minf',
      'residual', 'gamma', 'grad_norm', 'gamma_prb'} of shape (piter,),
      zero past 'iters_run'; 'minf' and 'residual' are taken before the
      object step, 'residual' is the relative misfit
      sqrt(max(minf - minf_perfect, 0) / sum(data)). 'host_syncs' counts
      the scalars the loop read on the host, 'evaluations' the objective
      evaluations (gradient passes, object and probe, and line-search
      candidates: on the frameless fused tiers the ``grad_fused``,
      ``grad_prb_fused`` and ``minf_fused`` passes; a fused line search
      counts once and reads its K values in one host read); 'cg_state'
      the carried state under ``carry_state``.
    """
    if options is None:
        options = CGOptions(**kw)
    elif kw:
        options = dataclasses.replace(options, **kw)
    options = normalize_options(options, diffraction._backend(psi0.device))
    # Where the JAX package's run() would partition the positions among
    # slabs (one device, unstreamed, frameless, fused), it checks the
    # column count first.
    slab_route = (all(getattr(options, a) is None for a in MESH_AXES)
                  and options.nchunks == 1
                  and options.memory != "materialized"
                  and options.kernel.startswith("fused"))
    if (slab_route and not options.obj_slabs_partitioned
            and options.obj_slab_cols < 1):
        raise ValueError("obj_slab_cols must be >= 1")
    return run_impl(geometry, options, data, psi0, scan, prb0, f_base,
                    cg_init)
