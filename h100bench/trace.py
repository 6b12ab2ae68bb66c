"""A ``torch.profiler`` window: how long the card was busy, on what, and
what the host was doing while it waited.

Busy time is the union of the intervals in which the card ran a kernel, a
copy or a set, so overlapping work counts once; the window is the host's
wall time between two synchronises around the traced work. An idle gap is
named by the last host operation (not a CUDA runtime call) that began
before the card went idle: ``aten::_local_scalar_dense`` is a host read of
a device scalar, for instance.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

TOP = 10  # entries of each breakdown list
NAME = 96  # characters of a name kept


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    device_ops: list  # [name, seconds], the most device time first
    idle_gaps: list  # [what the host was doing, seconds], longest first


def _merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def summarize(events, window_s: float) -> Profile | None:
    """A :class:`Profile` of kineto ``events``; None when nothing ran on the
    card."""
    from torch.autograd import DeviceType

    device, host = [], []
    by_name = {}
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((start, end))
            name = e.name()[:NAME]
            by_name[name] = by_name.get(name, 0) + (end - start)
        elif not e.name().startswith("cuda"):
            host.append((start, e.name()[:NAME]))
    if not device:
        return None
    busy = _merge(device)
    host.sort()
    starts = [s for s, _ in host]
    gaps = {}
    for (_, idle_from), (idle_to, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, idle_from) - 1
        what = "after " + host[i][1] if i >= 0 else "before any host op"
        gaps[what] = gaps.get(what, 0) + (idle_to - idle_from)

    def top(d):
        return [[k, v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Profile(window_s, sum(b - a for a, b in busy) * 1e-9,
                   top(by_name), top(gaps))


@contextlib.contextmanager
def window(sync):
    """Profile the body between two ``sync()``; the :class:`Profile` (or
    None) is left in the yielded list. Nothing is written to disk: a
    whole solve's Chrome trace is 0.4 GB, and the breakdown keeps what
    it shows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    holder = []
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield holder
        sync()
        wall = time.perf_counter() - t0
    holder.append(summarize(prof.profiler.kineto_results.events(), wall))


def idle_share(run) -> float | None:
    """The share of the profiled work (a cycle of jobs, or a solve) in
    which the card ran nothing, in %: 1 - the union of its kernel, copy and
    set intervals over what the same work took in the window without the
    profiler (whose own host work would lengthen the wall time). None
    without a profile."""
    if run.profile is None or not run.records():
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.unprofiled_s())
