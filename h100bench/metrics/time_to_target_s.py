"""time_to_target_s: the wall time of the window's solves to the target
residual, summed, over their count."""


def read(run):
    if not run.solves:
        return None
    return sum(r.seconds for r in run.solves) / len(run.solves)
