"""Tracing and timing hooks.

Counterpart of ``tikejax.utils.profiling``: a context manager around
``torch.profiler`` that writes a Chrome/Perfetto trace, a wall-clock timer
that waits for the card at both ends, and the convergence table of a
solver's metrics. PyTorch returns from a kernel launch before the card has
finished, so a host clock means something only between two
``torch.cuda.synchronize()``: that call is the barrier here (the JAX
package needs a host readback instead).

The port's own spans (:func:`span`) name the solver's phases: ``cg.run``,
``cg.iteration``, ``cg.line_search``, ``tiered.segment`` and the others the
README lists. They are off unless :func:`trace` or :func:`span_report` is
active; there each one is a ``record_function`` range named
``tikejax_torch.<name>`` on the profiler's timeline, on the clock of the
card's kernels. :func:`span_report` charges every stretch of time in which
the card ran nothing to the innermost span open on the host then, and each
kernel's time on the card to the span open when the host launched it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from pathlib import Path

import torch

from tikejax_torch.utils.bridge import to_numpy_tree


def _cuda_in_use() -> bool:
    """True once this process has a CUDA context: before that there is
    nothing to wait for, and a synchronise would only create one."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_sync(x=None) -> None:
    """Wait until the card has finished everything queued so far (``x`` is
    accepted for the JAX package's signature and ignored); a no-op while
    the card is not in use."""
    if _cuda_in_use():
        torch.cuda.synchronize()


def sync_overhead_seconds() -> float:
    """The fixed cost of one :func:`device_sync` on an idle card, for
    benchmarks to subtract (microseconds here; 0.0 without a card)."""
    device_sync()
    t0 = time.perf_counter()
    device_sync()
    return time.perf_counter() - t0


# The span names' prefix on the profiler's timeline.
PREFIX = "tikejax_torch."
# What span() returns while no span context is active: one shared object.
_NULL = contextlib.nullcontext()
# The spans of the active trace() or span_report(); None the rest of the
# time, which is all span() reads.
_recorder = None


@dataclasses.dataclass
class Span:
    """One span: its name (without :data:`PREFIX`), the index of its parent
    in the report's ``spans`` (None for a root), the ordinal of its root
    (every span of one job or solve shares it), and its start and end in
    ns on the profiler's clock."""
    name: str
    parent: int | None
    root: int
    start: int = 0
    end: int = 0


class _Recorder:
    """The spans opened so far, in the order they opened, and the ones
    still open, innermost last."""

    def __init__(self):
        self.spans: list[Span] = []
        self.open: list[int] = []
        self.roots = 0


class _Open:
    """One span while it is open: its :class:`Span`, and a
    ``record_function`` range that puts it on the profiler's timeline."""

    __slots__ = ("_rec", "_name", "_range")

    def __init__(self, rec: _Recorder, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        parent = rec.open[-1] if rec.open else None
        if parent is None:
            root, rec.roots = rec.roots, rec.roots + 1
        else:
            root = rec.spans[parent].root
        rec.open.append(len(rec.spans))
        rec.spans.append(Span(self._name, parent, root))
        self._range = torch.profiler.record_function(PREFIX + self._name)
        self._range.__enter__()

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._rec.open.pop()
        return False


def span(name: str):
    """The context manager of the span ``name`` (``'cg.line_search'``).
    Off, which is whenever neither :func:`trace` nor :func:`span_report`
    is active, it is one shared null context: no allocation, no string
    made."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _Open(rec, name)


@contextlib.contextmanager
def _spans_on():
    """Turn spans on for the body; yields the :class:`_Recorder`."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are on already: trace() and span_report() "
                           "do not nest")
    _recorder = rec = _Recorder()
    try:
        yield rec
    finally:
        _recorder = None


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace, written on exit to
    ``<logdir>/trace.json`` (open it in Perfetto or ``chrome://tracing``),
    the port's spans in it as ``tikejax_torch.<name>`` ranges:

    >>> with trace("/tmp/tikejax-trace") as prof:
    ...     run(...)  # traced
    >>> print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _cuda_in_use():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with _spans_on():
            try:
                yield prof
            finally:
                device_sync()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


@dataclasses.dataclass
class Figures:
    """What a span name (or a root) cost, summed over its spans: ``count``;
    ``wall_s``, their durations; ``self_s``, the part of it in which no
    child span was open; ``idle_self_s``, the card's idle time charged to
    the span itself (it was the innermost span open); ``idle_s``, that
    charged to it and its children; ``launches``, the kernels launched
    while it was open, children included (by the launch call's time on the
    host); ``device_s``, the card's time in the kernels launched while it
    was open, children included, each kernel tied to its launch call by
    the profiler's correlation id (a collective's kernel, which waits on
    the card for its peers, counts whole). The idle, launch and device
    fields are None off the card."""
    count: int = 0
    wall_s: float = 0.0
    self_s: float = 0.0
    idle_self_s: float | None = None
    idle_s: float | None = None
    launches: int | None = None
    device_s: float | None = None


@dataclasses.dataclass
class SpanReport:
    """What :func:`span_report` found: every span (``spans``, in the order
    they opened), the :class:`Figures` of each span name (``by_name``) and
    of each root's spans by name (``by_root``, one dict per root ordinal);
    the roots' summed wall time; the report's window (from the first span
    or busy interval to the last) and, on the card, the card's busy time
    (the union of its kernel, copy and set intervals), its idle time in
    the window, and the part of the idle time that fell while no span was
    open. ``idle_s`` is the sum of every span's ``idle_self_s`` and
    ``idle_unspanned_s``."""
    spans: list = dataclasses.field(default_factory=list)
    by_name: dict = dataclasses.field(default_factory=dict)
    by_root: list = dataclasses.field(default_factory=list)
    roots_wall_s: float = 0.0
    window_s: float = 0.0
    busy_s: float | None = None
    idle_s: float | None = None
    idle_unspanned_s: float | None = None


@contextlib.contextmanager
def span_report():
    """Profile the body (host and card) with the port's spans on; the
    yielded :class:`SpanReport` is filled in on exit. On the host the
    profiler records the spans and the CUDA runtime calls and no ATen
    operator: an operator's own profiling cost would lengthen the host's
    phases and the idle time charged to them. Nothing is written to disk
    (:func:`trace` is the exporter):

    >>> with span_report() as report:
    ...     run(...)
    >>> report.by_name["cg.line_search"].idle_s  # seconds the card sat
    ...                                          # idle in line searches
    """
    from torch._C._profiler import (ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)
    from torch.autograd import (_disable_profiler, _enable_profiler,
                                _prepare_profiler)

    activities = {torch.profiler.ProfilerActivity.CPU}
    cuda = torch.cuda.is_available()
    if cuda:
        activities.add(torch.profiler.ProfilerActivity.CUDA)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    report = SpanReport()
    device_sync()
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        with _spans_on() as rec:
            try:
                yield report
            finally:
                device_sync()
    finally:
        result = _disable_profiler()
    events = result.events()
    on_card = cuda and _cuda_in_use()
    _fill(report, *_timeline(events, rec.spans, on_card),
          _kernels_by_launch(events) if on_card else None)


def _timeline(events, spans, on_card: bool):
    """From the profiler's ``events``: the recorder's ``spans`` with their
    start and end, the card's busy intervals and the host times of kernel
    launches (None for both off the card), and the window ``(first,
    last)`` from the first span or busy interval to the last, all in ns on
    the profiler's clock. The card is busy while it runs a kernel, a copy
    or a set: every device event but the profiler's mirrors of the spans
    on the card, which are not work. A launch is a runtime or driver call
    whose name holds ``LaunchKernel``."""
    from torch.autograd import DeviceType

    cpu = DeviceType.CPU
    ranges, busy, launches = [], [], []
    for e in events:
        if e.device_type() == cpu:
            name = e.name()
            if name.startswith(PREFIX):
                ranges.append((e.start_ns(), -e.end_ns(),
                               name[len(PREFIX):]))
            elif "LaunchKernel" in name:
                launches.append(e.start_ns())
        elif not e.name().startswith(PREFIX):
            busy.append((e.start_ns(), e.end_ns()))
    ranges.sort()
    if len(ranges) != len(spans) or any(
            s.name != name for s, (_, _, name) in zip(spans, ranges)):
        raise RuntimeError(f"the profiler holds {len(ranges)} program "
                           f"spans, the recorder {len(spans)}, or their "
                           "order differs")
    for s, (start, minus_end, _) in zip(spans, ranges):
        s.start, s.end = start, -minus_end
    edges = [t for s in spans for t in (s.start, s.end)] + [
        t for interval in busy for t in interval]
    window = (min(edges), max(edges)) if edges else (0, 0)
    return spans, busy if on_card else None, \
        sorted(launches) if on_card else None, window


def _kernels_by_launch(events):
    """``[(t, ns)]`` in time order: for each launch call among the
    profiler's ``events`` (a host event whose name holds
    ``LaunchKernel``), its time ``t`` on the host and the card's time
    ``ns`` in the kernels it launched, tied to it by the CUDA correlation
    id that the call and its kernels share; every time in ns. None where
    launches were recorded but none could be tied (a profiler that shows
    no correlation)."""
    from torch.autograd import DeviceType

    cpu = DeviceType.CPU
    launched, ran = {}, {}
    for e in events:
        name = e.name()
        if name.startswith(PREFIX):
            continue
        if e.device_type() == cpu:
            if "LaunchKernel" in name:
                launched[e.correlation_id()] = e.start_ns()
        else:
            c = e.correlation_id()
            ran[c] = ran.get(c, 0) + e.end_ns() - e.start_ns()
    tied = sorted((launched[c], ns) for c, ns in ran.items()
                  if c in launched)
    return None if launched and not tied else tied


def _merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _innermost(spans):
    """``[(start, end, i)]``, in time order: the stretches in which span
    ``i`` was the innermost span open. Outside every root, none."""
    out, stack, t = [], [], 0
    for i, s in enumerate(spans):
        while stack and stack[-1] != s.parent:
            j = stack.pop()
            out.append((t, spans[j].end, j))
            t = spans[j].end
        if stack:
            out.append((t, s.start, stack[-1]))
        stack.append(i)
        t = s.start
    while stack:
        j = stack.pop()
        out.append((t, spans[j].end, j))
        t = spans[j].end
    return [seg for seg in out if seg[1] > seg[0]]


def _fill(report: SpanReport, spans, busy, launches, window,
          kernels=None) -> None:
    """Charge the idle time, the launches and the kernels' device time to
    ``spans`` (start and end filled in, in the order they opened: a parent
    before its children) and fill ``report`` with the sums. ``busy``
    (intervals), ``launches`` (host times) and ``kernels`` (``(host time
    of the launch, device time)``, :func:`_kernels_by_launch`) are None
    off the card; ``window`` is ``(first, last)``; every time is in
    ns."""
    n = len(spans)
    segments = _innermost(spans)
    self_ns = [0] * n
    for a, b, i in segments:
        self_ns[i] += b - a
    idle_self = launch_self = device_self = None
    if busy is not None:
        idle, t = [], window[0]
        for a, b in _merge(busy):
            if a > t:
                idle.append((t, min(a, window[1])))
            t = max(t, b)
        if window[1] > t:
            idle.append((t, window[1]))
        idle = [(a, b) for a, b in idle if b > a]
        idle_self, charged, k = [0] * n, 0, 0
        for a, b in idle:
            while k < len(segments) and segments[k][1] <= a:
                k += 1
            j = k
            while j < len(segments) and segments[j][0] < b:
                lo, hi = max(a, segments[j][0]), min(b, segments[j][1])
                if hi > lo:
                    idle_self[segments[j][2]] += hi - lo
                    charged += hi - lo
                j += 1
        total = sum(b - a for a, b in idle)
        report.busy_s = sum(b - a for a, b in _merge(busy)) * 1e-9
        report.idle_s = total * 1e-9
        report.idle_unspanned_s = (total - charged) * 1e-9
        launch_self = [0] * n
        starts = [seg[0] for seg in segments]

        def owner(t):
            """The span innermost at host time ``t``, or None."""
            j = bisect.bisect_right(starts, t) - 1
            return segments[j][2] if j >= 0 and t < segments[j][1] else None

        for t in launches:
            i = owner(t)
            if i is not None:
                launch_self[i] += 1
        if kernels is not None:
            device_self = [0] * n
            for t, ns in kernels:
                i = owner(t)
                if i is not None:
                    device_self[i] += ns
    idle_incl = None if idle_self is None else list(idle_self)
    launch_incl = None if launch_self is None else list(launch_self)
    device_incl = None if device_self is None else list(device_self)
    for i in reversed(range(n)):  # a child opened after its parent
        p = spans[i].parent
        if p is not None and idle_incl is not None:
            idle_incl[p] += idle_incl[i]
            launch_incl[p] += launch_incl[i]
        if p is not None and device_incl is not None:
            device_incl[p] += device_incl[i]
    report.spans = spans
    report.by_name = {}
    report.by_root = [{} for _ in range(1 + max((s.root for s in spans),
                                                default=-1))]
    for i, s in enumerate(spans):
        for table in (report.by_name, report.by_root[s.root]):
            f = table.setdefault(s.name, Figures(
                idle_self_s=None if idle_self is None else 0.0,
                idle_s=None if idle_self is None else 0.0,
                launches=None if launch_self is None else 0,
                device_s=None if device_self is None else 0.0))
            f.count += 1
            f.wall_s += (s.end - s.start) * 1e-9
            f.self_s += self_ns[i] * 1e-9
            if idle_self is not None:
                f.idle_self_s += idle_self[i] * 1e-9
                f.idle_s += idle_incl[i] * 1e-9
                f.launches += launch_incl[i]
            if device_self is not None:
                f.device_s += device_incl[i] * 1e-9
        if s.parent is None:
            report.roots_wall_s += (s.end - s.start) * 1e-9
    report.window_s = (window[1] - window[0]) * 1e-9


class Timer:
    """Wall-clock timing of named sections; with the card in use each
    section starts and ends with a synchronise, so it times the work and
    not the enqueueing.

    >>> timer = Timer()
    >>> with timer("cg"):
    ...     out = run(...)
    >>> timer.times["cg"]
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        device_sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device_sync()
            self.times[name] = time.perf_counter() - t0


def summarize_metrics(metrics, every: int = 1) -> str:
    """Human-readable convergence table from the solver's metric arrays
    (the JAX package's table, line for line)."""
    minf = to_numpy_tree(metrics["minf"])
    gamma = to_numpy_tree(metrics["gamma"])
    gnorm = to_numpy_tree(metrics["grad_norm"])
    lines = ["iter       minf        gamma    |grad|"]
    for i in range(0, len(minf), every):
        lines.append(
            f"{i:4d}  {minf[i]: .6e}  {gamma[i]:6.3f}  {gnorm[i]:.3e}")
    return "\n".join(lines)
