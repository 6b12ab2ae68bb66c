"""cg.all_reduce.idle_share.sharded-x4: the card's idle time charged to the
span ``cg.all_reduce`` on rank 0 (the host's side of a collective) over the
jobs' summed ``cg.run`` wall time, in %, from the program's span report of
the profiled cycle (``h100bench.spans``)."""

from h100bench import spans


def read(run):
    return spans.idle_share(run, "cg.all_reduce", "cg.run")
