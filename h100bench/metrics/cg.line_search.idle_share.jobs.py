"""cg.line_search.idle_share.jobs: the card's idle time charged to the line
search (the span ``cg.line_search`` and its children: every candidate, its
reads, ``parabolic_refine``) over the jobs' summed ``cg.run`` wall time, in
%, from the program's span report of the profiled cycle
(``h100bench.spans``)."""

from h100bench import spans


def read(run):
    return spans.idle_share(run, "cg.line_search", "cg.run")
