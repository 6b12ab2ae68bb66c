"""Multi-rank dry run on the CPU: one sharded CG step and one object-tiled
CG step over gloo ranks.

Counterpart of ``tikejax.parallel._dryrun``: where the JAX package runs its
steps on ``n`` virtual CPU devices, this runs them on ``n`` gloo ranks, each
a process of its own (``parallel.RankPool``), on the reference's tiny
shapes. P1/P2: a 64^2 object, ``8 n`` positions, a 12^2 probe in a 16^2
detector, two modes, one joint iteration (``recover_prb``) on the
``'fused'`` tier (its plain versions on the CPU); an even ``n`` runs a
``(2, n / 2)`` ``('theta', 'scan')`` mesh on two angles, any other ``n`` a
scan mesh. P3 (object tiling, ``parallel.run_tiled``), on the reference's
``g3`` (a 64^2 object, a balanced grid of 16 positions, a 12^2 probe in a
16^2 detector), one step: a 2-slab ``('obj',)`` mesh at 2 ranks, a ``(2, n
/ 2)`` ``('obj', 'scan')`` mesh at any other even ``n`` but 8, and at 8 the
``2 x 2 x 2`` ``('theta', 'obj', 'scan')`` mesh on two angles (the
reference's ``g4``); an odd ``n`` has no tiled step. Each step is held
against the same step in one process.

    python -m tikejax_torch.parallel._dryrun 4

``tikejax_torch.graft_entry.dryrun_multichip`` runs it in a subprocess.
"""

from __future__ import annotations

import sys

import torch

from tikejax_torch.geometry import Geometry

# The sharded step against the one-process step, of scale: the same
# complex64 arithmetic with the sums over positions in another order.
DRYRUN_TOL = 1e-5
STEP = dict(piter=1, recover_prb=True, kernel="fused")


def problem(n: int):
    """(geometry, mesh shape, (data, psi0, scan, prb)) of the dry run on
    ``n`` ranks, on the CPU, from a fixed seed."""
    from tikejax_torch.models import make_problem

    if n % 2 == 0 and n > 1:
        ntheta, mesh_shape = 2, (2, n // 2)
    else:
        ntheta, mesh_shape = 1, n
    g = Geometry(ntheta=ntheta, nz=64, n=64, nscan=8 * n, ndet=16, nprb=12,
                 nmodes=2)
    gen = torch.Generator().manual_seed(0)
    _, scan, prb, data = make_problem(gen, g, device="cpu")
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64)
    return g, mesh_shape, (data, psi0, scan, prb)


def tiled_problem(n: int):
    """(geometry, tiling mesh shape, (data, psi0, scan, prb)) of the P3
    step on ``n`` ranks (None for an odd ``n > 1``): the reference's
    ``g3`` on a balanced grid (8 positions a slab), on two angles on the
    three-axis mesh."""
    from tikejax_torch.models import make_problem, simulate_intensities

    if n == 2:
        ntheta, mesh_shape = 1, (2,)
    elif n == 8:
        ntheta, mesh_shape = 2, (2, 2, 2)
    elif n % 2 == 0:
        ntheta, mesh_shape = 1, (2, n // 2)
    else:
        return None
    g = Geometry(ntheta=ntheta, nz=64, n=64, nscan=16, ndet=16, nprb=12)
    gen = torch.Generator().manual_seed(1)
    psi, _, prb, _ = make_problem(gen, g, device="cpu")
    ys = torch.cat([torch.linspace(0, 31, 4), torch.linspace(32, 52, 4)])
    yy, xx = torch.meshgrid(ys, torch.linspace(0, 52, 2), indexing="ij")
    scan = torch.stack([yy.reshape(-1), xx.reshape(-1)], -1)[None].expand(
        ntheta, -1, -1).contiguous()
    data = simulate_intensities(psi, scan, prb, g.ndet)
    psi0 = torch.ones(g.psi_shape, dtype=torch.complex64)
    return g, mesh_shape, (data, psi0, scan, prb)


TILED_STEP = dict(piter=1)


def tiled_rank(rank: int, world: int):
    """A rank's part of the P3 step (a ``RankPool`` job): ``run_tiled`` on
    the tiling mesh of ``world`` ranks. Returns (psi, prb, minf,
    collectives made, halo broadcasts made)."""
    from tikejax_torch.parallel import _jobs, run_tiled
    from tikejax_torch.solvers import cg

    g, mesh_shape, (data, psi0, scan, prb) = tiled_problem(world)
    mesh = _jobs.tiling_mesh(mesh_shape)
    before = cg.all_reduce.launches, cg.halo_exchange.launches
    psi, prb_out, metrics = run_tiled(data, psi0, scan, prb, g, mesh,
                                      **TILED_STEP)
    return (psi, prb_out, metrics["minf"], cg.all_reduce.launches
            - before[0], cg.halo_exchange.launches - before[1])


def dryrun_rank(rank: int, world: int):
    """A rank's part (a ``RankPool`` job): the sharded step on the mesh of
    ``world`` ranks. Returns (psi, prb, minf, collectives made)."""
    from tikejax_torch.parallel import make_mesh, run_sharded
    from tikejax_torch.solvers import cg

    g, mesh_shape, (data, psi0, scan, prb) = problem(world)
    mesh = make_mesh(mesh_shape, device_type="cpu")
    before = cg.all_reduce.launches
    psi, prb_out, metrics = run_sharded(data, psi0, scan, prb, g, mesh,
                                        **STEP)
    return psi, prb_out, metrics["minf"], cg.all_reduce.launches - before


def _held(results, g, one, what):
    """The ranks' results (psi, prb, minf, counts...) checked: the same
    bits and counts on every rank, finite, of the right shape, and within
    DRYRUN_TOL of the one-process step ``one`` (psi, prb, metrics).
    Returns the errors {'psi', 'prb', 'minf'} and rank 0's counts."""
    psi, prb_out, minf = results[0][:3]
    for other in results[1:]:
        if not (torch.equal(other[0], psi) and torch.equal(other[1], prb_out)
                and other[3:] == results[0][3:]):
            raise RuntimeError(f"{what}: the ranks disagree: every rank "
                               "must end with the same object, probe and "
                               "count of collectives")
    if psi.shape != g.psi_shape or not bool(torch.isfinite(minf[0])):
        raise RuntimeError(f"{what}: psi {tuple(psi.shape)}, minf "
                           f"{float(minf[0])}")

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    errs = {"psi": err(psi, one[0]), "prb": err(prb_out, one[1]),
            "minf": err(minf[:1], one[2]["minf"][:1]),
            "collectives": results[0][3]}
    if max(errs["psi"], errs["prb"], errs["minf"]) > DRYRUN_TOL:
        raise RuntimeError(f"{what} off the one-process step: {errs}")
    return errs


def run_dryrun(n: int, pool=None) -> dict:
    """The sharded step on ``n`` ranks (``pool``, or a pool of its own) and,
    for an even ``n``, the tiled step, each checked: finite, of the right
    shapes, the same bits and collective counts on every rank, and within
    DRYRUN_TOL of the one-process step. Returns the sharded step's errors
    {'psi', 'prb', 'minf'} and the collectives a rank made, with the tiled
    step's likewise under 'tiled' (None without one; 'halo' its halo
    broadcasts a rank)."""
    from tikejax_torch.parallel import RankPool
    from tikejax_torch.solvers import run

    own = pool is None
    pool = RankPool(n) if own else pool
    tiled = tiled_problem(n)
    try:
        results = pool.run(dryrun_rank)
        tiled_results = pool.run(tiled_rank) if tiled else None
    finally:
        if own:
            pool.close()
    g, _, (data, psi0, scan, prb) = problem(n)
    errs = _held(results, g, run(data, psi0, scan, prb, g, **STEP),
                 "dry run")
    errs["tiled"] = None
    if tiled:
        g3, mesh_shape, (data, psi0, scan, prb) = tiled
        errs["tiled"] = _held(tiled_results, g3, run(
            data, psi0, scan, prb, g3, **TILED_STEP),
            f"tiled dry run on {mesh_shape}")
        errs["tiled"].update(mesh=mesh_shape, halo=tiled_results[0][4])
    return errs


def main(n: int) -> None:
    """Run the dry run on ``n`` CPU ranks and report."""
    torch.set_num_threads(1)
    errs = run_dryrun(n)
    line = (f"dryrun_multichip({n}): OK; against one process: psi "
            f"{errs['psi']:.2e}, prb {errs['prb']:.2e}, minf "
            f"{errs['minf']:.2e} (limit {DRYRUN_TOL:g}); "
            f"{errs['collectives']} all-reduces a rank")
    t = errs["tiled"]
    if t is not None:
        line += (f"; tiled on {t['mesh']}: psi {t['psi']:.2e}, minf "
                 f"{t['minf']:.2e}, {t['collectives']} all-reduces and "
                 f"{t['halo']} halo broadcasts a rank")
    print(line, flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
