"""tiered.iters_per_solve.deep: the CG iterations of a solve, summed over
the stages ``reconstruct`` returns (``iters_run`` each), averaged over the
window's solves."""


def read(run):
    if not run.solves:
        return None
    return sum(r.iters for r in run.solves) / len(run.solves)
