"""The program's own span report (``tikejax_torch.utils.profiling.
span_report``) of the cell's profiled work, for the span readers.

After the profiled window the same pool members run once more through the
cell's driver (``unit``: a cycle of jobs, or the one profiled solve) under
the report. The records that run appends are taken back and the program's
last answers restored, so that the other readers and the judge see
nothing of it; the report is kept on the run, so the readers make one
re-run between them. Off the card, or with a program that has no span
report, there is nothing to read: None.
"""

from __future__ import annotations

import time

_MISSING = object()


def report(run):
    """The span report of the profiled members, made once a run; None off
    the card, outside a traced run, or where the program has no report."""
    held = getattr(run, "span_report", _MISSING)
    if held is _MISSING:
        held = run.span_report = _rerun(run) if run.on_card else None
    return held


def _rerun(run):
    try:
        from tikejax_torch.utils.profiling import span_report
    except ImportError:
        return None
    members = [r.member for r in run.profiled_records]
    if not members:
        return None
    records = run.records()
    kept, last = len(records), dict(run.last)
    run.sync()
    try:
        with span_report() as rep:
            start = time.perf_counter()
            for k in members:
                run.cell.driver.unit(run, k)
            wall = time.perf_counter() - start
    finally:
        del records[kept:]
        run.last.clear()
        run.last.update(last)
    profiled = run.profile.window_s if run.profile is not None else None
    run.note(f"span report: {len(members)} runs of the program in "
             f"{wall!r} s (profiled window {profiled!r} s); idle "
             f"{rep.idle_s!r} s, {rep.idle_unspanned_s!r} s of it with no "
             "span open")
    return rep


def idle_share(run, part: str, whole: str, less: str | None = None):
    """100 x the idle time charged to the span ``part`` and its children
    (less that charged to ``less`` and its children, all inside ``part``)
    over the summed wall time of the span ``whole``, in %; None where there
    is no report or no ``whole`` span."""
    rep = report(run)
    if rep is None or whole not in rep.by_name:
        return None

    def idle(name):
        return rep.by_name[name].idle_s if name in rep.by_name else 0.0

    return 100.0 * (idle(part) - (idle(less) if less else 0.0)) \
        / rep.by_name[whole].wall_s


def launches_per(run, part: str, per: str):
    """The kernels launched while the span ``part`` was open over the count
    of ``per`` spans; None where there is no report or no ``per`` span."""
    rep = report(run)
    if rep is None or per not in rep.by_name:
        return None
    f = rep.by_name.get(part)
    return (f.launches if f is not None else 0) / rep.by_name[per].count
