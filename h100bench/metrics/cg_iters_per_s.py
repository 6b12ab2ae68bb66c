"""cg_iters_per_s: every CG iteration the window's jobs completed, over the
window's wall time from the start of its first job to the end of its last
(the gaps between jobs included)."""

from h100bench.stats import rate


def read(run):
    if not run.jobs:
        return None
    return rate(sum(r.iters for r in run.jobs), run.window_s)
