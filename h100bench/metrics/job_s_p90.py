"""job_s_p90: the 90th percentile of the wall time of a job, over every
job of the window."""

from h100bench.stats import percentile


def read(run):
    if not run.jobs:
        return None
    return percentile([r.seconds for r in run.jobs], 90)
