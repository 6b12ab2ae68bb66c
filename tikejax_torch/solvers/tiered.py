"""Deep-residual reconstruction: time to a target residual.

Counterpart of ``tikejax.solvers.tiered`` (``reconstruct``) for
single-device reconstructions, of the object or, with ``recover_prb``, of
the object and the probe. Two methods, as in the JAX package:

1. **Kernel-tier chaining** (``method='tiers'``): each tier of ``tiers``
   runs plain CG with an early-exit ``target_residual`` just above its
   floor and hands the object to the next.

2. **Split-operator refinement** (default, ``method='split'``): the fast
   tier runs to its floor; then the object is frozen as a base, its
   farplane is computed once with the accurate base kernel (``fwd``) and
   CG runs on the small correction ``delta`` with the fast kernels (cg's
   ``f_base``); the base is re-frozen between segments. The conjugate-
   gradient state is carried across segments, Anderson mixing over the
   segment outputs is kept or rejected by a safeguard that evaluates both
   candidates with the base kernel, a floor stop ends runs that no longer
   contract, and the outer state can be checkpointed and resumed.

   With ``recover_prb`` stage 1 is JOINT object+probe CG; for a target
   below the fast tier's floor a chain of four 128-iteration joint runs on
   the accurate tier (``joint_kernel``, default the base kernel) follows,
   then the probe is frozen for the object-only refinement. When the
   refinement stalls -- by the flat counter, or early, when two Aitken
   extrapolations of the per-segment residuals both predict a limit above
   1.2x the target -- the probe is re-opened with another joint chain (at
   most 4 refreshes), and the Anderson history, the pending base and the
   carried state start afresh.

Port notes. Where the JAX package picks its default kernels "on the TPU"
(fast 'fused', base 'fused_hp'), ``reconstruct`` picks them when the tensors
are on CUDA, and the oracle 'xla' path elsewhere. The step control lives
on the host (see ``tikejax_torch.solvers.cg``), so segments run one after
the other; the JAX package's one-deep speculation (the termination test
reads the PREVIOUS segment's status after the next segment was started) is
kept as control flow, so both packages run the same stages: after the
segment that reaches the target, one more segment runs, and exits after
one iteration. The safeguard's choice is read on the host (one scalar),
and its residuals are summed over chunks of positions, so no temporary as
large as the data is allocated.

The refinement inherits the caller's ``nchunks``: the frozen base is
streamed through the chunks with the data.

On a mesh (``mesh=``, ``tikejax_torch.parallel.make_mesh``; every rank
calls ``reconstruct`` with the global arrays) the problem is padded and
sharded once, every stage runs through ``parallel.run_sharded`` and the
base farplanes are frozen by ``parallel.fwd_sharded``, so they stay
sharded. The JAX package's own reductions here run on global arrays,
where XLA sums over the shards for free; here the farplanes and the data
are each rank's, so the Anderson safeguard's residuals (``sum(data)`` and
both candidates' objectives) are all-reduced, and every rank takes the
same choice. The object, the probe and the Anderson history are global on
every rank (``run_sharded`` returns them so), so the mix's Gram matrix is
the global one without a collective. Mesh runs keep the farplane-reusing
safeguard, as the JAX package's do. Rank 0 writes the checkpoints, from
the global state; every rank reads them.

Object-tiled meshes (an ``'obj'`` dimension) and the ``obj_*`` fields
raise ValueError: they are ``parallel.run_tiled``-only, as in the JAX
package, whose driver's iterate algebra works on whole-object arrays, not
overlapping slabs. The slab fields (``obj_slabs`` and the rest, see
``tikejax_torch.solvers.cg``) are checked as the JAX package's driver
checks them -- ``obj_slabs > 1`` needs every stage kernel on a fused tier
-- and then change nothing: the stages run the whole object in the
caller's scan order. The TPU slab partition and its backstop
(``_maybe_slab_partition``, the retry ladder) and ``hostio`` are not
ported by design.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from tikejax_torch.geometry import Geometry
from tikejax_torch.models import likelihoods
from tikejax_torch.ops import diffraction, fused
from tikejax_torch.ops import patches as _patches
from tikejax_torch.solvers import cg as _cg
from tikejax_torch.utils import checkpoint as _checkpoint
from tikejax_torch.utils.profiling import span

# (kernel, exit-residual floor, default max iterations) per tier, as in the
# JAX package. In this port every fused tier runs the same fp32 kernels.
DEFAULT_TIERS = (
    ("fused", diffraction.FUSED_RESIDUAL_FLOOR, 256),
    ("fused_mx", diffraction.FUSED_MP_RESIDUAL_FLOOR, 1024),
    ("fused_hp", 0.0, 8192),
)

# Per-segment residual contraction at or above which a segment counts as
# FLAT for the floor stop (< 0.5% progress).
_FLOOR_CONTRACTION = 0.995

# Anderson (AA-II) default mixing depth over the split-segment iterates.
_AA_DEPTH = 3

# Base-farplane byte size above which the Anderson safeguard evaluates
# both candidates' objectives with the frameless minf_fused kernel instead
# of materializing their farplanes (and the base is kept as the split
# (re, im) views): 3 GiB keeps the headline (a 2.1 GB farplane at 16384
# positions of 128^2) on the farplane-reusing safeguard, while the 8.6 GB
# farplane of 4 modes at that size never gets a second copy.
_SAFEGUARD_FRAMELESS_BYTES = 3 << 30

def reconstruct(data, psi0, scan, prb0, geometry: Geometry,
                target_residual: float = 1e-6,
                tiers=DEFAULT_TIERS, method: str = "split",
                segment: int = 256, max_segments: int = 48,
                base_kernel: str | None = None,
                fast_kernel: str | None = None,
                joint_kernel: str | None = None,
                segment_carry: bool = True,
                floor_patience: int = 3,
                accelerate: str | None = "anderson",
                mesh=None,
                checkpoint_path: str | None = None,
                checkpoint_every: int = 4,
                options: _cg.CGOptions | None = None, **kw):
    """Reconstruct to a target relative residual.

    Args:
      target_residual: relative residual sqrt(minf / sum(data)) to stop
        at (> 0).
      method: 'split' (default; fast tier to its floor, then split-operator
        refinement) or 'tiers' (escalate through ``tiers``).
      tiers: sequence of (kernel, exit_floor, max_piter). For 'split' only
        the first tier's floor and budget are used (stage 1).
      segment / max_segments: split-mode refinement segment length (CG
        iterations between base re-freezes) and budget.
      base_kernel / fast_kernel: split-mode kernels (defaults: 'fused_hp'
        / 'fused' when the tensors are on CUDA, the 'xla' oracle
        elsewhere); the hybrid 'pallas' tier serves as either, as in the
        JAX package (its refinement segments keep the base farplane and
        ``G psi`` in memory).
      joint_kernel: kernel of the joint escalation and probe-refresh
        chains under recover_prb (default: base_kernel).
      segment_carry: continue the CG trajectory across re-bases (the
        terminal state seeds the next segment through cg's ``cg_init``);
        segments that end early, and mixes the safeguard takes, restart
        fresh.
      floor_patience: stop after this many consecutive refinement
        segments that each contracted the residual by less than 0.5%
        (0 disables).
      accelerate: 'anderson' (depth 3), 'anderson:<depth>' (2..8) or
        None: safeguarded Anderson mixing over the segment iterates
        (split mode only).
      checkpoint_path / checkpoint_every: split mode saves its whole outer
        state (atomically, ``tikejax_torch.utils.checkpoint``) every
        ``checkpoint_every`` segments and right after stage 1; the same
        call with the same path resumes from it and reproduces the rest
        of the trajectory. The file is removed on success; a mismatched
        call raises.
      mesh: a position-sharding mesh (``parallel.make_mesh``: 1-D, or 2-D
        ``('theta', 'scan')`` with ``ntheta`` divisible by its theta
        dimension); every rank of it calls ``reconstruct`` with the global
        arrays and gets the global result. The scan axis is padded once to
        a multiple of the scan dimension with sentinel dummies.
      options / kw: base CGOptions (piter, kernel and target_residual are
        set per stage). ``direction='auto'`` resolves to Dai-Yuan for
        stage 1 and the joint chains, and to L-BFGS (m=8) for the
        refinement segments. With ``recover_prb=True`` split mode runs
        stage 1 jointly, escalates the joint recovery to the accurate tier
        for a target below the fast tier's floor, freezes the probe for
        the refinement and re-opens it on a stall (see the module note).

    Returns:
      (psi, prb, stages): stages is a list of (stage_name, metrics);
      metrics['iters_run'] holds each stage's iteration count.
    """
    if options is None:
        options = _cg.CGOptions(**kw)
    elif kw:
        options = dataclasses.replace(options, **kw)
    tiled = [f"{name}={getattr(options, name)!r}"
             for name, default in _cg.OBJ_FIELDS.items()
             if getattr(options, name) != default]
    if tiled or "obj" in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(
            "reconstruct: object-tiled ('obj', ...) meshes are run_tiled-only "
            "(tikejax_torch.parallel.run_tiled): the driver's iterate "
            "algebra works on whole-object arrays, not overlapping slabs"
            + (f"; got {', '.join(tiled)}" if tiled else ""))
    if target_residual <= 0:
        raise ValueError("target_residual must be > 0; for fixed-count "
                         "runs use tikejax_torch.solvers.run")
    if method not in ("split", "tiers"):
        raise ValueError(f"unknown method {method!r}")
    if checkpoint_path is not None:
        if method != "split":
            raise ValueError("checkpoint_path applies to method='split' "
                             "only (tier stages are single runs)")
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
    if accelerate is not None and _parse_anderson_depth(accelerate) is None:
        raise ValueError(f"unknown accelerate {accelerate!r}; use None, "
                         "'anderson', or 'anderson:<depth>'")
    _check_slab_stages(options, psi0.device, method, tiers, base_kernel,
                       fast_kernel, joint_kernel, mesh)
    with span("tiered.reconstruct"):
        if mesh is not None:
            from tikejax_torch.parallel import sharding

            sharding._check_mesh(mesh)
            _, _, tsh, nsh, _, _ = sharding._layout(mesh)
            if geometry.ntheta % tsh:
                raise ValueError(
                    f"ntheta ({geometry.ntheta}) must be divisible by the "
                    f"theta mesh axis size ({tsh})")
            data, scan, geometry = sharding.pad_scan_problem(data, scan,
                                                             geometry, nsh)
            data, scan = sharding.shard_problem(mesh, data, scan)
        if method == "split":
            return _reconstruct_split(
                data, psi0, scan, prb0, geometry, target_residual, segment,
                max_segments, base_kernel, fast_kernel, options, tiers,
                segment_carry, floor_patience, accelerate, joint_kernel,
                checkpoint_path, checkpoint_every, mesh)
        run_fn = _make_run_fn(mesh)

        psi, prb = psi0, prb0
        stages = []
        for tier_i, (kernel, floor, max_piter) in enumerate(tiers):
            tier_target = max(target_residual, floor)
            # Runs of at most 512 iterations, as in the JAX package (there a
            # longer device program risked the transport's deadline); a run
            # started after the target was reached exits after one iteration.
            remaining = max_piter
            while remaining > 0:
                seg = min(remaining, 512)
                tier_opts = dataclasses.replace(
                    options, kernel=kernel, piter=seg,
                    target_residual=tier_target,
                    direction="dy" if tier_i == 0 else options.direction)
                with span("tiered.stage"):
                    psi, prb, metrics = run_fn(data, psi, scan, prb,
                                               geometry, tier_opts)
                stages.append((kernel, metrics))
                remaining -= seg
            if floor <= target_residual:
                break  # this tier could reach the target; done
        return psi, prb, stages


def _check_slab_stages(options, device, method, tiers, base_kernel,
                       fast_kernel, joint_kernel, mesh) -> None:
    """The JAX package's slab checks for the deep driver, before any stage
    runs: one device, every stage kernel a fused tier (its
    ``_maybe_slab_partition``); on a mesh, the first stage's solver checks
    (``cg.check_slabs``). A valid slab request changes nothing here."""
    if options.obj_slabs == 1:
        return
    backend = diffraction._backend(device)
    on_cuda = backend == "cuda"
    if method == "split":
        kernels = [fast_kernel or ("fused" if on_cuda else "xla"),
                   base_kernel or ("fused_hp" if on_cuda else "xla")]
        if options.recover_prb:
            kernels.append(joint_kernel or kernels[1])
    else:
        kernels = [k for k, _, _ in tiers]
    if mesh is not None:
        _cg.check_slabs(dataclasses.replace(options, kernel=kernels[0]),
                        backend, on_mesh=True)
    elif options.obj_slabs > 1 and not all(
            diffraction.resolve_kernel(k, backend).startswith("fused")
            for k in kernels):
        raise ValueError("obj_slabs > 1 requires every driver stage kernel "
                         f"to be a fused tier; this call would run "
                         f"{kernels!r}")


def _make_run_fn(mesh):
    """The stage runner: ``cg.run``, or ``parallel.run_sharded`` on the
    mesh (the same call, ``f_base`` and ``cg_init`` included)."""
    if mesh is None:
        return _cg.run
    from tikejax_torch.parallel import run_sharded

    def run_fn(data, psi0, scan, prb0, geometry, options, f_base=None,
               cg_init=None):
        return run_sharded(data, psi0, scan, prb0, geometry, mesh, options,
                           f_base=f_base, cg_init=cg_init)

    return run_fn


def _make_reduce(mesh):
    """A sum over every rank of a scalar that each rank's data make, or the
    identity without a mesh."""
    if mesh is None:
        return lambda x: x
    import torch.distributed as dist

    return lambda x: _cg.all_reduce(x, dist.group.WORLD)


def _reconstruct_split(data, psi0, scan, prb, g, target, segment,
                       max_segments, base_kernel, fast_kernel, options,
                       tiers, segment_carry=True, floor_patience=3,
                       accelerate=None, joint_kernel=None,
                       checkpoint_path=None, checkpoint_every=4, mesh=None):
    """Fast tier to its floor, then split-operator refinement segments;
    with recover_prb, joint stages and probe refreshes around them. With
    ``mesh`` (data and scan this rank's padded slice, ``g`` the padded
    global geometry) every stage runs through ``run_sharded`` and the base
    freeze through ``fwd_sharded``."""
    on_cuda = psi0.device.type == "cuda"
    fast = fast_kernel or ("fused" if on_cuda else "xla")
    base = base_kernel or ("fused_hp" if on_cuda else "xla")
    run_fn = _make_run_fn(mesh)
    reduce = _make_reduce(mesh)

    if mesh is None:
        def fwd_base(psi_, scan_, prb_):
            return diffraction.fwd_raw(psi_, scan_, prb_, g.ndet, base)
    else:
        from tikejax_torch.parallel import fwd_sharded

        def fwd_base(psi_, scan_, prb_):
            return fwd_sharded(psi_, scan_, prb_, g.ndet, base, mesh)

    floor = tiers[0][1] if tiers else diffraction.FUSED_RESIDUAL_FLOOR
    stages = []

    ck = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        with span("tiered.checkpoint"):
            ck = _checkpoint.load(checkpoint_path)
            _ckpt_validate(ck, g, segment, target)

    recover = options.recover_prb
    # The joint escalation and refresh chains: Dai-Yuan runs of 128 joint
    # iterations on the accurate tier, four at a time.
    joint_opts = dataclasses.replace(options, kernel=joint_kernel or base,
                                     piter=128, target_residual=target,
                                     direction="dy")
    if ck is None:
        # Stage 1: plain Dai-Yuan CG on the fast tier down to its floor
        # (an L-BFGS-warmed flat start lands in bad basins); joint with
        # recover_prb.
        opts1 = dataclasses.replace(options, kernel=fast, direction="dy",
                                    piter=tiers[0][2] if tiers else 256,
                                    target_residual=max(target, floor))
        with span("tiered.stage"):
            psi, prb, m = run_fn(data, psi0, scan, prb, g, opts1)
        stages.append((fast + (":joint" if recover else ""), m))
        if recover and target < floor:
            # A probe frozen at the fast tier's accuracy would floor the
            # refinement: escalate the joint recovery first.
            psi, prb, _ = _joint_chain(data, psi, scan, prb, g, joint_opts,
                                       stages, run_fn=run_fn)
        if target >= floor:
            return psi, prb, stages
    else:
        psi = _to_tensor(ck["psi"], psi0.device)
        prb = _to_tensor(ck["prb"], psi0.device)
    if recover:
        options = dataclasses.replace(options, recover_prb=False)

    # Stage 2: split-operator refinement with the fast kernels on the
    # correction; 'auto' is L-BFGS here (and only here).
    refine_dir = ("lbfgs" if options.direction == "auto"
                  else options.direction)
    opts2 = dataclasses.replace(options, kernel=fast, piter=segment,
                                target_residual=target,
                                carry_state=segment_carry,
                                direction=refine_dir)
    state = _cg.zero_cg_state(psi, opts2) if segment_carry else None

    # Safeguard flavour by base-farplane size: the farplane-reusing
    # safeguard materializes both candidates' farplanes and hands the
    # winner's forward as the next base; above the threshold both
    # objectives come from minf_fused and the base stays one tensor. Mesh
    # runs keep the farplane-reusing one, as in the JAX package.
    minf_base_fn = None
    if (mesh is None and base.startswith("fused")
            and math.prod(g.farplane_shape)
            * psi.element_size() > _SAFEGUARD_FRAMELESS_BYTES):
        minf_base_fn = _make_minf_base(g)
        fwd_base = _make_fwd_base_split(g)
    fwd_base = _spanned("tiered.base_freeze", fwd_base)

    prev = None
    flat = 0
    aa_hist = []  # Anderson history of (segment output, correction)
    res_hist = []  # per-segment end residuals
    budget = max_segments
    # Probe refreshes left: a floor stall may be the frozen probe's error.
    refreshes = 4 if recover else 0
    aa_depth = (_parse_anderson_depth(accelerate) if accelerate is not None
                else 0)
    f_next = None  # chosen farplane handed forward by the Anderson step
    if ck is not None:
        with span("tiered.checkpoint"):
            (flat, budget, refreshes, res_hist, prev, aa_hist,
             state) = _ckpt_restore(ck, state, psi0.device)
    elif checkpoint_path is not None:
        with span("tiered.checkpoint"):
            _ckpt_save(checkpoint_path, g, segment, target, psi, prb,
                       budget, flat, refreshes, res_hist, prev, aa_hist,
                       state, mesh)
    seg_i = 0
    while budget > 0:
        with span("tiered.segment"):
            budget -= 1
            f_base = (f_next if f_next is not None
                      else fwd_base(psi, scan, prb))
            f_next = None
            delta0 = torch.zeros(g.psi_shape, dtype=psi.dtype,
                                 device=psi.device)
            delta, _, m = run_fn(data, delta0, scan, prb, g, opts2,
                                 f_base=f_base, cg_init=state)
            f_base = None  # at scale the base IS the memory budget
            psi = psi + delta
            stages.append((f"split:{fast}", m))
            if segment_carry:
                state = _masked_state(m["cg_state"], m["iters_run"],
                                      segment)
            if aa_depth:
                # History holds raw segment outputs and their corrections;
                # a taken mix never enters it.
                aa_hist.append((psi, delta))
                del aa_hist[:-aa_depth]
                if len(aa_hist) >= 2:
                    with span("tiered.anderson"):
                        if minf_base_fn is not None:
                            psi, took, f_next = _anderson_step_frameless(
                                [p for p, _ in aa_hist],
                                [d for _, d in aa_hist], data, scan, prb,
                                minf_base_fn)
                        else:
                            psi, took, f_next = _anderson_step(
                                [p for p, _ in aa_hist],
                                [d for _, d in aa_hist], data, scan, prb,
                                fwd_base, reduce)
                    if segment_carry:
                        # A taken mix moves psi off the carried trajectory.
                        state = _masked_state_flag(state, took)
            # The termination test reads the PREVIOUS segment's status (the
            # JAX package's one-deep speculation; see the module note).
            if prev is not None:
                with span("tiered.status"):
                    reached, contraction, res_end = _segment_status(
                        prev, segment, target)
                    if reached:
                        break
                    res_hist.append(res_end)
                    can_refresh = refreshes > 0 and budget > 0
                    want_refresh = False
                    if contraction > _FLOOR_CONTRACTION:
                        flat += 1
                        if floor_patience > 0 and flat >= floor_patience:
                            if not can_refresh:
                                break  # pinned at the base's or data's floor
                            want_refresh = True
                    else:
                        flat = 0
                    if (not want_refresh and can_refresh
                            and _probe_floor_predicted(res_hist, target)):
                        want_refresh = True  # nearing a frozen-probe floor
                if want_refresh:
                    refreshes -= 1
                    budget -= 1
                    psi, prb, (r_reached, r_contr) = _joint_chain(
                        data, psi, scan, prb, g, joint_opts, stages,
                        target=target, run_fn=run_fn)
                    if r_reached:
                        _ckpt_done(checkpoint_path, mesh)
                        return psi, prb, stages
                    if r_contr > _FLOOR_CONTRACTION:
                        break  # the probe refresh is flat too: genuine floor
                    # The joint run changed the map and the probe: restart
                    # the Anderson history, the pending base and the
                    # carried state.
                    flat, prev = 0, None
                    res_hist = []
                    aa_hist = []
                    f_next = None
                    state = (_cg.zero_cg_state(psi, opts2) if segment_carry
                             else None)
                    continue
            prev = m
            seg_i += 1
            if checkpoint_path is not None and seg_i % checkpoint_every == 0:
                with span("tiered.checkpoint"):
                    _ckpt_save(checkpoint_path, g, segment, target, psi, prb,
                               budget, flat, refreshes, res_hist, prev,
                               aa_hist, state, mesh)
    _ckpt_done(checkpoint_path, mesh)
    return psi, prb, stages


def _joint_chain(data, psi, scan, prb, g, joint_opts, stages, target=None,
                 run_fn=None):
    """Four joint runs one after the other (``run_fn``: ``cg.run`` by
    default, or the mesh's ``run_sharded``), each appended as a
    '<kernel>:joint' stage. With ``target``, the third element is (reached,
    residual contraction across the chain); else None."""
    run_fn = run_fn or _cg.run
    ms = []
    with span("tiered.joint_chain"):
        for _ in range(4):
            psi, prb, m = run_fn(data, psi, scan, prb, g, joint_opts)
            stages.append((joint_opts.kernel + ":joint", m))
            ms.append(m)
    if target is None:
        return psi, prb, None
    kl = int(ms[-1]["iters_run"])
    res_end = float(_to_numpy(ms[-1]["residual"])[max(kl - 1, 0)])
    reached = kl < joint_opts.piter and res_end <= target
    r0 = float(_to_numpy(ms[0]["residual"])[0])
    return psi, prb, (reached, res_end / max(r0, 1e-300))


def _aitken_limit(r0, r1, r2):
    """Aitken delta-squared estimate of the limit of a near-geometric
    residual sequence, or None when the three points are not a
    decelerating monotone decay (ratio outside (0, 0.95))."""
    d1, d2 = r1 - r0, r2 - r1
    if d1 >= 0 or d2 >= 0:
        return None
    rho = d2 / d1
    if not 0.0 < rho < 0.95:
        return None
    return r2 - d2 * d2 / (d2 - d1)


def _probe_floor_predicted(res_hist, target):
    """Early probe-floor detection on the per-segment end residuals: the
    last two Aitken extrapolations both predict a limit above 1.2x the
    target (the refinement is approaching the frozen probe's error, not
    the target)."""
    if len(res_hist) < 4:
        return False
    lim1 = _aitken_limit(*res_hist[-4:-1])
    lim2 = _aitken_limit(*res_hist[-3:])
    return (lim1 is not None and lim2 is not None
            and lim1 > 1.2 * target and lim2 > 1.2 * target)


def _masked_state(cg_state, iters_run, segment):
    """The carried state, or all zeros (a fresh start) when the segment
    ended early (stall or target): a stalled direction is one the line
    search already rejected. Budget-exhausted segments always carry."""
    return _masked_state_flag(cg_state, int(iters_run) < segment)


def _masked_state_flag(cg_state, restart: bool):
    """All zeros (what cg.run starts from without ``cg_init``) when
    ``restart``, e.g. after a taken Anderson mix; else the state."""
    if restart:
        return tuple(torch.zeros_like(x) for x in cg_state)
    return cg_state


def _parse_anderson_depth(accelerate):
    """Depth for 'anderson'/'anderson:<d>' (2..8), else None."""
    if accelerate == "anderson":
        return _AA_DEPTH
    if isinstance(accelerate, str) and accelerate.startswith("anderson:"):
        try:
            d = int(accelerate.split(":", 1)[1])
        except ValueError:
            return None
        if 2 <= d <= 8:
            return d
    return None


def _anderson_mix(psis, deltas):
    """x_mix = sum_j alpha_j G(x_j) with alpha minimizing ||sum_j alpha_j
    r_j|| subject to sum_j alpha_j = 1, on the (Tikhonov-regularized) real
    Gram matrix of the corrections r_j. The m x m solve runs on the host.
    On a mesh the iterates and corrections are global on every rank, and
    so is the Gram matrix, with no collective."""
    m = len(deltas)
    R = torch.stack([d.reshape(-1) for d in deltas])  # (m, N) complex
    G = (R @ R.conj().T).real.cpu()
    Greg = G + (1e-7 * torch.trace(G) / m + 1e-30) * torch.eye(
        m, dtype=G.dtype)
    alpha = torch.linalg.solve(Greg, torch.ones(m, dtype=G.dtype))
    alpha = alpha / torch.sum(alpha)
    stacked = torch.stack(psis)
    return torch.einsum("i,i...->...", alpha.to(stacked.device,
                                                stacked.dtype), stacked)


def _anderson_step(psis, deltas, data, scan, prb, fwd_base,
                   reduce=lambda x: x):
    """One safeguarded Anderson step: form the mix, compute both
    candidates' farplanes with the base kernel and keep the candidate
    with the smaller gaussian residual. Returns (chosen iterate, took-mix
    flag, chosen farplane): the farplane is the next segment's base. On a
    mesh the farplanes are this rank's, and ``reduce`` sums the residuals'
    parts over the ranks."""
    psi_mix = _anderson_mix(psis, deltas)
    psi_plain = psis[-1]
    f_mix = fwd_base(psi_mix, scan, prb)
    f_plain = fwd_base(psi_plain, scan, prb)
    return _anderson_select(psi_mix, psi_plain, f_mix, f_plain, data,
                            reduce)


def _anderson_select(psi_mix, psi_plain, f_mix, f_plain, data,
                     reduce=lambda x: x):
    sum_d = reduce(_cg._sum_over_positions(
        lambda c: torch.sum(torch.clamp_min(c, 0.0)), data))

    def res(f):
        minf = reduce(_cg._sum_over_positions(likelihoods.gaussian_minf, f,
                                              data))
        return torch.sqrt(torch.clamp_min(minf, 0.0) / sum_d)

    if bool(res(f_mix) < res(f_plain)):
        return psi_mix, True, f_mix
    return psi_plain, False, f_plain


def _spanned(name: str, fn):
    """``fn`` with each call inside the span ``name``."""

    def call(*args):
        with span(name):
            return fn(*args)

    return call


def _make_minf_base(g: Geometry):
    """The base kernel's frameless gaussian objective psi -> minf
    (``fused.minf_fused``): nothing farplane-sized is allocated. Every
    ``fused*`` base tier is the same fp32 kernel."""

    def minf_base(psi_, scan_, prb_, data_):
        return fused.minf_fused(psi_, data_, _patches.scan_to_int(scan_),
                                prb_, g.ndet, "gaussian")

    return minf_base


def _make_fwd_base_split(g: Geometry):
    """Base freeze as the (re, im) views of one complex farplane
    (``fused.fwd(split_out=True)``), the form the JAX package keeps in
    the memory-bound regime; the kernels read it without a copy."""

    def fwd_base(psi_, scan_, prb_):
        return fused.fwd(psi_, _patches.scan_to_int(scan_), prb_, g.ndet,
                         split_out=True)

    return fwd_base


def _anderson_step_frameless(psis, deltas, data, scan, prb, minf_base):
    """Memory-bound variant of :func:`_anderson_step`: both candidates'
    gaussian objectives from the frameless base kernel (the residual is
    monotone in minf, so the choice matches); the winner's farplane is not
    handed forward (returns None)."""
    psi_mix = _anderson_mix(psis, deltas)
    psi_plain = psis[-1]
    take = bool(minf_base(psi_mix, scan, prb, data)
                < minf_base(psi_plain, scan, prb, data))
    return (psi_mix if take else psi_plain), take, None


def _segment_status(m, segment, target):
    """(reached, contraction, res_end) of a completed split segment: an
    early exit counts as reached only when the residual met the target (a
    stalled segment gets a fresh base); contraction is res_end/res_start,
    the floor-stop statistic."""
    ran = int(m["iters_run"])
    res = _to_numpy(m["residual"])
    res_end = float(res[max(ran - 1, 0)])
    reached = ran < segment and res_end <= target
    contraction = res_end / max(float(res[0]), 1e-300)
    return reached, contraction, res_end


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


# --- outer-loop checkpointing: the JAX package's file layout -------------


def _ckpt_save(path, g, segment, target, psi, prb, budget, flat,
               refreshes, res_hist, prev, aa_hist, state, mesh=None):
    """Write the outer state; on a mesh every rank calls it (the carried
    state's per-angle entries are gathered), rank 0 writes the file and the
    ranks wait for one another."""
    if mesh is not None:
        import torch.distributed as dist

        from tikejax_torch.parallel.sharding import gather_state

        state = gather_state(state, mesh)
        if dist.get_rank() == 0:
            _ckpt_save(path, g, segment, target, psi, prb, budget, flat,
                       refreshes, res_hist, prev, aa_hist, state)
        dist.barrier()
        return
    tree = {
        "meta": {
            "version": np.int64(1),
            "segment": np.int64(segment),
            "target": np.float64(target),
            "geom": np.asarray([g.ntheta, g.nz, g.n, g.nscan, g.ndet,
                                g.nprb, g.nmodes], np.int64),
        },
        "psi": psi,
        "prb": prb,
        "ctl": {
            "budget": np.int64(budget),
            "flat": np.int64(flat),
            "refreshes": np.int64(refreshes),
            "res_hist": np.asarray(res_hist, np.float64),
            "has_prev": np.int64(prev is not None),
        },
    }
    if prev is not None:
        # Everything _segment_status consumes from the previous segment.
        tree["prev"] = {"iters_run": prev["iters_run"],
                        "residual": prev["residual"]}
    if aa_hist:
        tree["aa"] = {
            "psis": {str(i): p for i, (p, _) in enumerate(aa_hist)},
            "deltas": {str(i): d for i, (_, d) in enumerate(aa_hist)},
        }
    if state is not None:
        tree["state"] = {str(i): x for i, x in enumerate(state)}
    _checkpoint.save(path, tree)


def _ckpt_validate(ck, g, segment, target):
    meta = ck.get("meta")
    geom = np.asarray([g.ntheta, g.nz, g.n, g.nscan, g.ndet, g.nprb,
                       g.nmodes], np.int64)
    if meta is None or "geom" not in meta:
        raise ValueError("checkpoint_path exists but is not a reconstruct "
                         "split-mode checkpoint")
    if (not np.array_equal(np.asarray(meta["geom"]), geom)
            or int(meta["segment"]) != segment
            or float(meta["target"]) != target):
        raise ValueError(
            "existing checkpoint was written by a DIFFERENT reconstruct "
            "call (geometry/segment/target mismatch); remove it or pass "
            "the original arguments to resume")


def _ckpt_restore(ck, state, device):
    """Loop state from a loaded checkpoint: complex arrays go to
    ``device``, the state's host scalars stay on the CPU. ``state`` is the
    fresh zero state, replaced only when the checkpoint carried one."""
    ctl = ck["ctl"]
    res_hist = [float(x) for x in np.asarray(ctl["res_hist"]).ravel()]
    prev = None
    if int(ctl["has_prev"]):
        prev = {"iters_run": ck["prev"]["iters_run"],
                "residual": ck["prev"]["residual"]}
    aa_hist = []
    if "aa" in ck:
        psis, deltas = ck["aa"]["psis"], ck["aa"]["deltas"]
        aa_hist = [(_to_tensor(psis[str(i)], device),
                    _to_tensor(deltas[str(i)], device))
                   for i in range(len(psis))]
    if "state" in ck and state is not None:
        st = ck["state"]
        state = tuple(
            _to_tensor(st[str(i)], device if np.iscomplexobj(st[str(i)])
                       else "cpu") for i in range(len(st)))
    return (int(ctl["flat"]), int(ctl["budget"]), int(ctl["refreshes"]),
            res_hist, prev, aa_hist, state)


def _ckpt_done(path, mesh=None):
    """Remove the checkpoint on successful completion, so re-running the
    same call starts fresh instead of resuming a finished run (on a mesh,
    rank 0 removes it and the ranks wait for one another)."""
    if mesh is not None and path is not None:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _ckpt_done(path)
        dist.barrier()
        return
    if path is not None and os.path.exists(path):
        os.remove(path)
