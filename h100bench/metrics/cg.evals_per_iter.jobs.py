"""cg.evals_per_iter.jobs: the objective evaluations ``solvers.run``
counts (``metrics['evaluations']``: gradient passes and line-search
candidates), summed over the jobs, over their summed ``iters_run``."""


def read(run):
    if not run.jobs:
        return None
    return (sum(r.evaluations for r in run.jobs)
            / sum(r.iters for r in run.jobs))
