"""Multi-rank dry run on the CPU: one sharded CG step over gloo ranks.

Counterpart of the P1/P2 part of ``tikejax.parallel._dryrun``: where the
JAX package runs one position-sharded CG step on ``n`` virtual CPU devices,
this runs it on ``n`` gloo ranks, each a process of its own
(``parallel.RankPool``), on the reference's tiny shapes: a 64^2 object,
``8 n`` positions, a 12^2 probe in a 16^2 detector, two modes, one joint
iteration (``recover_prb``) on the ``'fused'`` tier (its plain versions on
the CPU). An even ``n`` runs a ``(2, n / 2)`` ``('theta', 'scan')`` mesh on
two angles, any other ``n`` a scan mesh. The step is held against the same
step in one process. The JAX package's object-tiling parts (P3) wait for
object tiling (ROADMAP.md queue 1 item 5).

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


def run_dryrun(n: int, pool=None) -> dict:
    """The sharded step on ``n`` ranks (``pool``, or a pool of its own),
    checked: finite, of the right shapes, the same bits and collective
    counts on every rank, and within DRYRUN_TOL of the one-process step.
    Returns the errors {'psi', 'prb', 'minf'} and the collectives a rank
    made."""
    from tikejax_torch.parallel import RankPool
    from tikejax_torch.solvers import run

    own = pool is None
    pool = RankPool(n) if own else pool
    try:
        results = pool.run(dryrun_rank)
    finally:
        if own:
            pool.close()
    g, _, (data, psi0, scan, prb) = problem(n)
    psi_1, prb_1, m_1 = run(data, psi0, scan, prb, g, **STEP)
    psi, prb_out, minf, collectives = results[0]
    for other in results[1:]:
        if not (torch.equal(other[0], psi) and torch.equal(other[1], prb_out)
                and other[3] == collectives):
            raise RuntimeError("the ranks disagree: every rank must end "
                               "with the same object, probe and count of "
                               "collectives")
    if psi.shape != g.psi_shape or not bool(torch.isfinite(minf[0])):
        raise RuntimeError(f"dry run: psi {tuple(psi.shape)}, minf "
                           f"{float(minf[0])}")

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    errs = {"psi": err(psi, psi_1), "prb": err(prb_out, prb_1),
            "minf": err(minf[:1], m_1["minf"][:1]),
            "collectives": collectives}
    if max(errs["psi"], errs["prb"], errs["minf"]) > DRYRUN_TOL:
        raise RuntimeError(f"dry run off the one-process step: {errs}")
    return errs


def main(n: int) -> None:
    """Run the dry run on ``n`` CPU ranks and report."""
    torch.set_num_threads(1)
    errs = run_dryrun(n)
    print(f"dryrun_multichip({n}): OK; against one process: psi "
          f"{errs['psi']:.2e}, prb {errs['prb']:.2e}, minf "
          f"{errs['minf']:.2e} (limit {DRYRUN_TOL:g}); "
          f"{errs['collectives']} all-reduces a rank", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
