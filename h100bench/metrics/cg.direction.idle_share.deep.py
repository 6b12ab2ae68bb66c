"""cg.direction.idle_share.deep: the card's idle time charged to the search
direction (the span ``cg.direction`` and its children: Dai-Yuan, or
``lbfgs_push`` with its read and the two-loop) over the solve's
``tiered.reconstruct`` wall time, in %, from the program's span report of
the profiled solve (``h100bench.spans``)."""

from h100bench import spans


def read(run):
    return spans.idle_share(run, "cg.direction", "tiered.reconstruct")
