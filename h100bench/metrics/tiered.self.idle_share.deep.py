"""tiered.self.idle_share.deep: the card's idle time inside
``tiered.reconstruct`` while no ``cg.run`` was open (the deep driver's own
work: base freezes, Anderson steps, segment status, the stages' hand-over)
over its wall time, in %, from the program's span report of the profiled
solve (``h100bench.spans``)."""

from h100bench import spans


def read(run):
    return spans.idle_share(run, "tiered.reconstruct", "tiered.reconstruct",
                             less="cg.run")
