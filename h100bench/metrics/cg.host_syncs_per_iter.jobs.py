"""cg.host_syncs_per_iter.jobs: the scalars the CG loop read on the host
(``metrics['host_syncs']``), summed over the jobs, over their summed
``iters_run``."""


def read(run):
    if not run.jobs:
        return None
    return (sum(r.host_syncs for r in run.jobs)
            / sum(r.iters for r in run.jobs))
