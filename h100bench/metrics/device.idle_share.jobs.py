"""device.idle_share.jobs: the share of one whole profiled cycle of jobs
in which the card ran nothing, in % (``trace.idle_share``)."""

from h100bench import trace


def read(run):
    return trace.idle_share(run)
