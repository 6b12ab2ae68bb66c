"""cg.setup.idle_share.jobs: the card's idle time charged to a job's set-up
(the span ``cg.setup`` and its children: the integer scan, the
preconditioners, the ``sum(data)`` and Poisson offset reads, the initial
state, the merged body's first gradient pass) over the jobs' summed
``cg.run`` wall time, in %, from the program's span report of the profiled
cycle (``h100bench.spans``)."""

from h100bench import spans


def read(run):
    return spans.idle_share(run, "cg.setup", "cg.run")
