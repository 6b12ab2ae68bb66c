"""device.idle_share.deep: the share of one whole profiled solve in which
the card ran nothing, in % (``trace.idle_share``)."""

from h100bench import trace


def read(run):
    return trace.idle_share(run)
