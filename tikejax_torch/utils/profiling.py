"""Tracing and timing hooks.

Counterpart of ``tikejax.utils.profiling``: a context manager around
``torch.profiler`` that writes a Chrome/Perfetto trace, a wall-clock timer
that waits for the card at both ends, and the convergence table of a
solver's metrics. PyTorch returns from a kernel launch before the card has
finished, so a host clock means something only between two
``torch.cuda.synchronize()``: that call is the barrier here (the JAX
package needs a host readback instead).
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace, written on exit to
    ``<logdir>/trace.json`` (open it in Perfetto or ``chrome://tracing``):

    >>> with trace("/tmp/tikejax-trace") as prof:
    ...     run(...)  # traced
    >>> print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _cuda_in_use():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            device_sync()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


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
