"""device.idle_share.sharded-x4: the share of one whole profiled cycle of
sharded jobs in which rank 0's card ran nothing, in %
(``trace.idle_share``)."""

from h100bench import trace


def read(run):
    return trace.idle_share(run)
