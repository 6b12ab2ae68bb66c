"""One run of one cell: set-up, the measured window, the per-layer
readings, the check against the plain reference, and the result line.

The order is fixed. Set-up (``setup_s``) runs from the process's start to
the start of the window's first job: torch, the CUDA context, the
program's kernel libraries (built into ``<checkout>/build/kernels`` on a
checkout's first run, loaded from there after), the configuration's pool
of problems made on the card, and one warm-up of the cell's own shapes.
Then the window runs whole cycles of the pool, each in an order drawn from
``--seed``, as many as end within ``--seconds`` (at least one); with ``--trace 1`` one more cycle of jobs, or one more solve, runs
under ``torch.profiler``. Then the device's peak memory is read, the
per-layer readers run (they may time a kernel on the program's last
state), and the reference judges the program's last answer on every
problem of the pool, each answer dropped once judged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import random
import statistics
import sys
import time
import types
from pathlib import Path

from h100bench import roofline, trace
from h100bench import problem as _problem
from h100bench.spec import ROOT, SpecError, load

JAX_NAMES = ("jax", "jaxlib", "flax", "tikejax")
PROGRAM = "tikejax_torch"


@dataclasses.dataclass
class Record:
    """One job or solve, between two synchronises."""
    member: int  # the problem of the pool it ran on
    start: float
    end: float
    iters: int
    evaluations: int
    host_syncs: int
    stages: list = dataclasses.field(default_factory=list)  # iters a stage
    final: float | None = None  # a solve's last recorded residual
    reached: bool = True  # a solve's stage list ends at its target

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Run:
    """What one run knows: the cell, its pool of problems, the window's
    records, the program's last answer on each problem, the profile; what
    the drivers, the readers and the judge share."""

    Record = Record

    def __init__(self, cell, device, program, traced: bool = False,
                 seed: int = 0):
        import torch

        self.torch = torch
        self.cell = cell
        self.device = device
        self.program = program
        self.traced = traced
        self.order = random.Random(seed)
        self.problems = []
        self.geometry = None
        self.setup_s = None
        self.jobs: list[Record] = []
        self.solves: list[Record] = []
        self.profiled_records: list[Record] = []
        self.last = {}  # pool member -> the program's output there
        self.profile = None
        self.solutions = {}  # pool member -> the reference's

    def make_problems(self, seeds) -> None:
        """The pool: one problem a generator seed."""
        self.problems = [_problem.make(self.cell.config, s, self.device)
                         for s in seeds]
        self.geometry = self.program.Geometry(**self.problems[0].geometry)
        self.last, self.solutions = {}, {}

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize(self.device)

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    def records(self) -> list[Record]:
        return self.jobs or self.solves

    @property
    def window_s(self) -> float:
        recs = self.records()
        return recs[-1].end - recs[0].start

    def cycle(self) -> list[int]:
        """The pool's members in an order drawn from the run's seed."""
        return self.order.sample(range(len(self.problems)),
                                 len(self.problems))

    def cycles(self, seconds: float, records: list):
        """Members of whole cycles of the pool, cycle after cycle, while
        ``records`` (which the caller fills) with one more cycle as long as
        the last would still span no more than ``seconds``. The first cycle
        always runs, so the window is whole cycles and ends within one
        cycle of ``seconds``, before it (or is one cycle, where that is
        longer)."""
        while True:
            first = len(records)
            yield from self.cycle()
            last = records[-1].end - records[first].start
            if records[-1].end - records[0].start + last > seconds:
                return

    def unprofiled_s(self) -> float:
        """What the profiled records took without the profiler: each one's
        problem's mean time in the window (the work is the same)."""
        total = 0.0
        for r in self.profiled_records:
            same = [w.seconds for w in self.records() if w.member == r.member]
            total += sum(same) / len(same)
        return total

    @contextlib.contextmanager
    def profiled(self):
        """Run the body under the profiler; its summary lands in
        ``self.profile``."""
        with trace.window(self.sync) as holder:
            yield
        if holder:
            self.profile = holder[0]

    def time_ms(self, fn, reps: int = 10) -> float | None:
        """Median of ``reps`` calls of ``fn``, each timed with CUDA events,
        after one warm-up call; None off the card."""
        if not self.on_card:
            return None
        torch = self.torch
        fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(self.device)
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def load_program():
    """The program under test, imported from this checkout: its solvers,
    kernels and geometry. Raises SpecError if ``tikejax_torch`` is not the
    checkout's own."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        import tikejax_torch
        from tikejax_torch import geometry, solvers
        from tikejax_torch.ops import fused
    except ImportError as exc:
        raise SpecError(f"cannot import {PROGRAM} from {ROOT}: {exc}")
    where = Path(tikejax_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise SpecError(f"{PROGRAM} was imported from {where}, not from "
                        f"the checkout {ROOT}")
    return types.SimpleNamespace(solvers=solvers, fused=fused,
                                 Geometry=geometry.Geometry)


def loaded_jax() -> list[str]:
    """The JAX-side top-level modules this process holds."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(JAX_NAMES))


def _finite(value):
    """A reading as JSON can carry it: a float, or its name when it is not
    finite (which fails its limit)."""
    value = float(value)
    return value if math.isfinite(value) else str(value)


def judge(run) -> dict:
    """Each number the driver's judge reads on the program's last answer
    on every problem of the pool, at its worst over them; each problem's
    readings go to standard error."""
    worst = {}
    for k in sorted(run.last):
        numbers = run.cell.driver.judge(run, k,
                                        run.cell.driver.answer(run, k))
        run.note(f"problem {k}: " + ", ".join(
            f"{name} {value!r}" for name, value in numbers.items()))
        for name, value in numbers.items():
            worst[name] = max(worst.get(name, -math.inf), value)
    return worst


def execute(cell, seed: int, seconds: float, traced: bool, device,
            program, t0: float, marks=()) -> dict:
    """One run of ``cell``; returns the result line as a dict (``checks``
    last). ``marks`` are ``(step, perf_counter())`` of the set-up done
    before the call."""
    import torch

    marks = list(marks)
    run = Run(cell, device, program, traced, seed)
    if run.on_card:
        run.note(f"card: {roofline.card()}; peaks {roofline.PEAK_FLOPS:g} "
                 f"FLOP/s (float32 SIMT), {roofline.PEAK_BYTES:g} B/s")
    marks.append(("card read", time.perf_counter()))
    run.make_problems(cell.config["pool_seeds"])
    run.sync()
    marks.append(("pool made", time.perf_counter()))
    cell.driver.warm_up(run)
    run.sync()
    if run.on_card:
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("warm-up", time.perf_counter()))
    run.setup_s = marks[-1][1] - t0
    run.note("set-up: " + ", ".join(
        f"{step} {b - a:.3f} s" for (step, b), a in
        zip(marks, [t0] + [t for _, t in marks])))
    cell.driver.window(run, seconds)
    peak = torch.cuda.max_memory_allocated(device) if run.on_card else 0
    recs = run.records()
    times = [r.seconds for r in recs]
    half = len(recs) // 2
    run.note(f"window: {len(recs)} runs of the program in "
             f"{run.window_s:.3f} s; one takes {min(times):.4f} / "
             f"{statistics.median(times):.4f} / {max(times):.4f} s (least "
             "/ median / most); iterations a second in the first and the "
             "second half: " + " / ".join(
                 f"{sum(r.iters for r in p) / (p[-1].end - p[0].start):.2f}"
                 for p in (recs[:half], recs[half:]) if p))
    metrics = {}
    for name, unit, reader in (cell.per_layer if traced
                               else cell.end_to_end):
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    numbers = judge(run)
    checks = {name: {"value": _finite(numbers.get(name, math.inf)),
                     "limit": limit}
              for name, limit in cell.limits.items()}
    correct = bool(checks) and all(
        isinstance(c["value"], float) and c["value"] <= c["limit"]
        for c in checks.values())
    dev = {"platform": "gpu" if run.on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if run.on_card
                    else device.type),
           "count": cell.chips, "memory_peak_bytes": peak}
    reckoned = (f"{cell.device_bytes} B" if cell.device_bytes is not None
                else "not reckoned")
    run.note(f"memory: peak {peak} B in the window, reckoned {reckoned}")
    result = {"correct": correct, "attempted": len(recs),
              "failed": sum(not r.reached for r in recs),
              "metrics": metrics, "device": dev}
    if traced and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
        result["breakdown"] = {"device_ops": run.profile.device_ops,
                               "idle_gaps": run.profile.idle_gaps}
    result["checks"] = checks
    return result


def main(args, t0: float) -> int:
    try:
        cell = load(args.workload)
    except SpecError as exc:
        print(f"h100bench: {exc}", file=sys.stderr)
        return 2
    # The program's build and kernel caches stay inside the checkout.
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch

    marks = [("torch imported", time.perf_counter())]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.zeros((), device=device)
    marks.append(("CUDA context", time.perf_counter()))
    try:
        program = load_program()
    except SpecError as exc:
        print(f"h100bench: {exc}", file=sys.stderr)
        return 4
    marks.append(("program imported", time.perf_counter()))
    torch.set_num_threads(1)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     device, program, t0, marks)
    bad = loaded_jax()
    if bad:
        print(f"h100bench: this process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
