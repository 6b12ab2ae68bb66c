"""cg.all_reduce.per_iter.sharded-x4: the all-reduces rank 0 made in the
window's jobs (the program's counter ``solvers.cg.all_reduce.launches``,
read before and after each job's ``run_sharded``), over the jobs' summed
``iters_run``."""


def read(run):
    counted = [r for r in run.jobs if hasattr(r, "all_reduces")]
    if not counted:
        return None
    return (sum(r.all_reduces for r in counted)
            / sum(r.iters for r in counted))
