"""cg.direction.launches_per_iter.deep: the kernels launched while the
span ``cg.direction`` was open (by the launch call's time on the host;
Dai-Yuan, or ``lbfgs_push`` and the two-loop) over the count of
``cg.iteration`` spans, from the program's span report of the profiled
solve (``h100bench.spans``)."""

from h100bench import spans


def read(run):
    return spans.launches_per(run, "cg.direction", "cg.iteration")
