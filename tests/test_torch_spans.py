"""The port's spans (``utils.profiling.span``) and their report
(``span_report``): the spans count what the solver's own counters count,
nest as the loop does, change no bit, cost nothing while off, and the
report charges the card's idle time by the arithmetic its docstring
states. Tiny problems on the CPU; the tests marked ``cuda`` run the report
on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_spans.py
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from torch.autograd import DeviceType  # noqa: E402

from tikejax_torch import Geometry  # noqa: E402
from tikejax_torch.models import make_problem  # noqa: E402
from tikejax_torch.ops import kernels  # noqa: E402
from tikejax_torch.ops.patches import scan_to_int  # noqa: E402
from tikejax_torch.solvers import cg, reconstruct, run  # noqa: E402
from tikejax_torch.utils import profiling  # noqa: E402
from tikejax_torch.utils.profiling import (Span, SpanReport,  # noqa: E402
                                           span, span_report)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small problems: one intra-op thread keeps the parallel test run
    from oversubscribing the cores; restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOM = Geometry(nz=48, n=48, nscan=36, ndet=16, nprb=12)
ITERS = 6
# The loop bodies and step controls, on the fused tiers' plain versions.
BODIES = {
    "merged": dict(kernel="fused_mx"),
    "merged-lbfgs-interp": dict(kernel="fused_mx", direction="lbfgs",
                                linesearch="interp"),
    "classic-frameless": dict(kernel="fused_mx", merged_linesearch="off"),
    "materialized": dict(kernel="fused_mx", memory="materialized"),
    "materialized-fused-ls": dict(kernel="fused_mx", memory="materialized",
                                  fused_linesearch=True),
    "joint": dict(kernel="fused_mx", recover_prb=True),
    "streamed-parabolic": dict(kernel="xla", nchunks=2,
                               linesearch="parabolic"),
}


def problem(device="cpu", dtype=torch.complex128):
    gen = torch.Generator(device=device).manual_seed(0)
    psi, scan, prb, data = make_problem(gen, GEOM, dtype=dtype,
                                        device=device)
    return data, torch.ones_like(psi), scan, prb


@pytest.fixture(scope="module")
def runs():
    """Each body run twice, with the report on and with spans off:
    ``{body: (report, (psi, prb, metrics) on, the same off)}``."""
    data, psi0, scan, prb = problem()
    out = {}
    for body, kw in BODIES.items():
        with span_report() as report:
            on = run(data, psi0, scan.clone(), prb, GEOM, piter=ITERS, **kw)
        off = run(data, psi0, scan.clone(), prb, GEOM, piter=ITERS, **kw)
        out[body] = report, on, off
    return out


def count(report, name):
    f = report.by_name.get(name)
    return 0 if f is None else f.count


@pytest.mark.parametrize("body", BODIES)
def test_an_iteration_span_an_iteration(runs, body):
    report, (_, _, m), _ = runs[body]
    assert int(m["iters_run"]) == ITERS
    assert count(report, "cg.iteration") == ITERS
    assert count(report, "cg.update") == ITERS
    assert count(report, "cg.probe_step") == (
        ITERS if BODIES[body].get("recover_prb") else 0)


@pytest.mark.parametrize("body", BODIES)
def test_a_host_read_span_a_counted_read(runs, body):
    report, (_, _, m), _ = runs[body]
    assert count(report, "cg.host_read") == m["host_syncs"] > ITERS


@pytest.mark.parametrize("body", BODIES)
def test_an_evaluation_span_a_counted_evaluation(runs, body):
    report, (_, _, m), _ = runs[body]
    assert (count(report, "cg.grad_pass") + count(report, "cg.minf_pass")
            == m["evaluations"] >= ITERS)


def ancestors(spans, i):
    while spans[i].parent is not None:
        i = spans[i].parent
        yield spans[i]


@pytest.mark.parametrize("body", BODIES)
def test_phases_nest_in_an_iteration_of_one_run(runs, body):
    report, _, _ = runs[body]
    spans = report.spans
    assert [s.name for s in spans if s.parent is None] == ["cg.run"]
    assert {s.root for s in spans} == {0}
    assert count(report, "cg.setup") == 1
    for i, s in enumerate(spans):
        if s.name in ("cg.direction", "cg.line_search", "cg.update"):
            names = [a.name for a in ancestors(spans, i)]
            assert "cg.iteration" in names and names[-1] == "cg.run"
        if s.name == "cg.host_read":
            assert not any(a.name == "cg.host_read"
                           for a in ancestors(spans, i))
    by = report.by_root[0]
    assert by.keys() == report.by_name.keys()
    run_ = report.by_name["cg.run"]
    assert run_.wall_s == pytest.approx(report.roots_wall_s)
    # Off the card there is no idle time and no launch to charge.
    assert report.idle_s is None and run_.idle_s is None
    assert run_.launches is None and report.busy_s is None
    assert 0 < run_.self_s < run_.wall_s <= report.window_s


@pytest.mark.parametrize("body", BODIES)
def test_no_device_time_off_the_card(runs, body):
    report, _, _ = runs[body]
    assert report.by_name and all(
        f.device_s is None for table in [report.by_name, *report.by_root]
        for f in table.values())


@pytest.mark.parametrize("body", BODIES)
def test_the_report_changes_no_bit(runs, body):
    _, on, off = runs[body]
    for a, b in zip(on[:2], off[:2]):
        assert torch.equal(a, b)
    assert on[2].keys() == off[2].keys()
    for key, value in on[2].items():
        if torch.is_tensor(value):
            assert torch.equal(value, off[2][key]), key
        else:
            assert value == off[2][key], key


def test_off_a_span_is_one_shared_null_and_nothing_is_profiled():
    assert span("cg.iteration") is span("tiered.segment")
    assert span("x") is profiling._NULL
    data, psi0, scan, prb = problem()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(data, psi0, scan, prb, GEOM, piter=2, kernel="fused_mx")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names and not any(n.startswith(profiling.PREFIX) for n in names)


def test_span_contexts_do_not_nest(tmp_path):
    with span_report():
        assert span("a") is not profiling._NULL
        with pytest.raises(RuntimeError, match="do not nest"):
            with profiling.trace(str(tmp_path)):
                pass
    assert span("a") is profiling._NULL


def test_trace_writes_the_span_names(tmp_path):
    data, psi0, scan, prb = problem()
    with profiling.trace(str(tmp_path)):
        run(data, psi0, scan, prb, GEOM, piter=2, kernel="fused_mx")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    for name in ("cg.run", "cg.setup", "cg.iteration", "cg.line_search",
                 "cg.grad_pass", "cg.host_read"):
        assert profiling.PREFIX + name in names
    assert span("a") is profiling._NULL


# -- the charging arithmetic, on synthetic spans and intervals (ns) ------


def spans_of(*rows):
    """(name, parent, start, end) rows, in the order they opened."""
    out, roots = [], 0
    for name, parent, start, end in rows:
        if parent is None:
            root, roots = roots, roots + 1
        else:
            root = out[parent].root
        out.append(Span(name, parent, root, start, end))
    return out


def fill(spans, busy, launches=(), window=None):
    report = SpanReport()
    window = window or (min(s.start for s in spans),
                        max(s.end for s in spans))
    profiling._fill(report, spans, busy, sorted(launches), window)
    return report


# A job: run [0, 100) holds setup [0, 20) and an iteration [20, 100),
# which holds a line search [30, 80), which holds two reads [40, 50) and
# [60, 70).
JOB = [("run", None, 0, 100), ("setup", 0, 0, 20), ("iteration", 0, 20, 100),
       ("line_search", 2, 30, 80), ("read", 3, 40, 50), ("read", 3, 60, 70)]
# The card ran [0, 10), [45, 65) twice over (overlapping kernels), and
# [90, 95).
BUSY = [(0, 10), (45, 60), (50, 65), (90, 95)]
# Idle: [10, 45) [65, 90) [95, 100).
CASES = {
    # name: (idle charged to the span itself, with its children)
    "run": (0, 65),
    "setup": (10, 10),
    "iteration": (10 + 10 + 5, 55),
    "line_search": (10 + 10, 30),
    "read": (5 + 5, 10),
}


@pytest.mark.parametrize("name", CASES)
def test_the_innermost_span_takes_the_idle(name):
    report = fill(spans_of(*JOB), BUSY)
    alone, inclusive = CASES[name]
    f = report.by_name[name]
    assert f.idle_self_s == pytest.approx(alone * 1e-9)
    assert f.idle_s == pytest.approx(inclusive * 1e-9)


def test_overlapping_kernels_count_once():
    report = fill(spans_of(*JOB), BUSY)
    assert report.busy_s == pytest.approx((10 + 20 + 5) * 1e-9)
    assert report.idle_s == pytest.approx(65 * 1e-9)
    assert report.idle_unspanned_s == 0


def test_wall_and_self_time():
    report = fill(spans_of(*JOB), BUSY)
    assert report.by_name["read"].count == 2
    assert report.by_name["read"].wall_s == pytest.approx(20e-9)
    assert report.by_name["line_search"].self_s == pytest.approx(30e-9)
    assert report.by_name["iteration"].self_s == pytest.approx(30e-9)
    assert report.by_name["run"].self_s == 0
    assert report.roots_wall_s == pytest.approx(100e-9)


def test_idle_outside_the_roots_is_not_charged():
    # Two jobs, [0, 100) and [150, 200), in a window [0, 260): the card
    # idles between them and after them.
    rows = JOB + [("run", None, 150, 200), ("iteration", 6, 150, 200)]
    report = fill(spans_of(*rows), BUSY + [(160, 170)], window=(0, 260))
    assert report.idle_s == pytest.approx((65 + 50 + 40 + 60) * 1e-9)
    assert report.idle_unspanned_s == pytest.approx((50 + 60) * 1e-9)
    charged = sum(f.idle_self_s for f in report.by_name.values())
    assert charged + report.idle_unspanned_s == pytest.approx(
        report.idle_s, abs=1e-15)
    assert report.by_name["run"].idle_s == pytest.approx((65 + 40) * 1e-9)
    assert [r["run"].idle_s for r in report.by_root] == [
        pytest.approx(65e-9), pytest.approx(40e-9)]
    assert report.by_root[1].keys() == {"run", "iteration"}


def test_launches_by_the_host_time_of_the_call():
    report = fill(spans_of(*JOB), BUSY, launches=[5, 25, 45, 55, 65, 120])
    assert report.by_name["read"].launches == 2  # 45 and 65
    assert report.by_name["line_search"].launches == 3
    assert report.by_name["iteration"].launches == 4
    assert report.by_name["run"].launches == 5  # not 120, after it


def test_device_time_by_the_launch_that_queued_it():
    # (host time of the launch, ns on the card): the kernel launched at 45
    # ran long after its read closed, and still counts to the read.
    kernels = [(5, 4), (25, 3), (45, 200), (65, 8), (120, 50)]
    launches = [t for t, _ in kernels]
    with_device = fill(spans_of(*JOB), BUSY, launches)
    report = SpanReport()
    profiling._fill(report, spans_of(*JOB), BUSY, launches, (0, 100),
                    kernels)
    device = {name: f.device_s for name, f in report.by_name.items()}
    assert device == pytest.approx({
        "run": 215e-9, "setup": 4e-9, "iteration": 211e-9,
        "line_search": 208e-9, "read": 208e-9})  # not 120's, after run
    assert [r["run"].device_s for r in report.by_root] == [
        pytest.approx(215e-9)]
    # The other figures are those of a report without device times.
    for name, f in report.by_name.items():
        assert dataclasses.replace(f, device_s=None) == \
            with_device.by_name[name]
    assert with_device.by_name["run"].device_s is None


class Event:
    """A kineto event as ``_timeline`` reads it (``kind``, kineto's
    activity type, says what the event is; not every torch has it)."""

    def __init__(self, name, kind, start, end, device=DeviceType.CPU):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_annotation_mirrors_are_not_busy():
    cuda = DeviceType.CUDA
    spans = spans_of(("run", None, 0, 0), ("read", 0, 0, 0))
    events = [
        Event("tikejax_torch.read", "user_annotation", 40, 50),
        Event("tikejax_torch.run", "user_annotation", 10, 100),
        Event("tikejax_torch.run", "gpu_user_annotation", 12, 99, cuda),
        Event("grad_kernel", "kernel", 20, 30, cuda),
        Event("Memcpy DtoH", "gpu_memcpy", 45, 47, cuda),
        Event("Memset", "gpu_memset", 60, 61, cuda),
        Event("cudaLaunchKernel", "cuda_runtime", 15, 16),
        Event("cudaMemcpyAsync", "cuda_runtime", 44, 45),
        Event("aten::add", "cpu_op", 5, 6),
    ]
    spans, busy, launches, window = profiling._timeline(events, spans, True)
    assert [(s.name, s.start, s.end) for s in spans] == [
        ("run", 10, 100), ("read", 40, 50)]
    assert sorted(busy) == [(20, 30), (45, 47), (60, 61)]
    # The window runs from the first span or busy interval to the last.
    assert launches == [15] and window == (10, 100)
    report = fill(spans, busy, launches, window)
    assert report.busy_s == pytest.approx(13e-9)
    assert report.idle_s == pytest.approx(77e-9)
    assert report.idle_unspanned_s == 0
    assert report.by_name["read"].idle_s == pytest.approx(8e-9)
    # Off the card: no busy time and no launches, the spans' times kept.
    spans, busy, launches, _ = profiling._timeline(events, spans, False)
    assert busy is None and launches is None and spans[0].end == 100


class Launched(Event):
    """An event with the CUDA correlation id that ties a launch call to
    its kernels."""

    def __init__(self, name, start, end, corr, device=DeviceType.CPU):
        super().__init__(name, None, start, end, device)
        self._c = corr

    def correlation_id(self):
        return self._c


def test_kernels_are_tied_to_their_launch_by_correlation():
    cuda = DeviceType.CUDA
    events = [
        Launched("cudaLaunchKernel", 15, 16, 7),
        Launched("cuLaunchKernelEx", 40, 41, 9),
        Launched("cudaMemcpyAsync", 44, 45, 11),
        Launched("tikejax_torch.read", 40, 50, 0),
        Launched("tikejax_torch.read", 41, 49, 0, cuda),  # a mirror
        Launched("grad_kernel", 20, 30, 7, cuda),
        Launched("ncclDevKernel_AllReduce", 42, 90, 9, cuda),
        Launched("Memcpy DtoH", 45, 47, 11, cuda),  # no kernel launch
    ]
    assert profiling._kernels_by_launch(events) == [(15, 10), (40, 48)]
    # Launches but nothing tied: the profiler shows no correlation.
    lost = [Launched("cudaLaunchKernel", 15, 16, 7),
            Launched("grad_kernel", 20, 30, 0, cuda)]
    assert profiling._kernels_by_launch(lost) is None
    assert profiling._kernels_by_launch([]) == []


def test_a_span_the_profiler_lost_raises():
    spans = spans_of(("run", None, 0, 0), ("read", 0, 0, 0))
    events = [Event("tikejax_torch.run", "user_annotation", 10, 100)]
    with pytest.raises(RuntimeError, match="program spans"):
        profiling._timeline(events, spans, False)


# -- the deep driver and the scan plan -----------------------------------

DEEP = dict(target_residual=1e-5, segment=6, max_segments=6,
            tiers=(("xla", 5e-3, 20),))


@pytest.mark.parametrize("accelerate", ["anderson", None])
def test_a_segment_span_a_split_stage(accelerate):
    data, psi0, scan, prb = problem()
    with span_report() as report:
        _, _, stages = reconstruct(data, psi0, scan, prb, GEOM,
                                   accelerate=accelerate, **DEEP)
    segments = sum(name.startswith("split:") for name, _ in stages)
    assert segments >= 2
    assert count(report, "tiered.reconstruct") == 1
    assert count(report, "tiered.stage") == len(stages) - segments == 1
    assert count(report, "tiered.segment") == segments
    assert count(report, "cg.run") == len(stages)
    assert count(report, "tiered.status") == segments - 1
    spans = report.spans
    assert [s.name for s in spans if s.parent is None] == [
        "tiered.reconstruct"]
    anderson = count(report, "tiered.anderson")
    if accelerate is None:
        assert anderson == 0
        # One base freeze a segment.
        assert count(report, "tiered.base_freeze") == segments
    else:
        # From the second segment on, an Anderson step freezes both
        # candidates' bases and hands the winner's to the next segment.
        assert anderson == segments - 1
        assert count(report, "tiered.base_freeze") == 2 * segments
        for i, s in enumerate(spans):
            if s.name == "tiered.base_freeze":
                assert spans[s.parent].name in ("tiered.segment",
                                                "tiered.anderson")
    for i, s in enumerate(spans):
        if s.name == "cg.run":
            assert spans[s.parent].name in ("tiered.stage", "tiered.segment")


def test_a_tiers_run_is_a_stage_a_run():
    data, psi0, scan, prb = problem()
    with span_report() as report:
        _, _, stages = reconstruct(
            data, psi0, scan, prb, GEOM, method="tiers",
            target_residual=1e-3, tiers=(("xla", 1e-3, 8),))
    assert count(report, "tiered.stage") == len(stages) == 1
    assert count(report, "tiered.segment") == 0


def test_the_scan_plan_is_made_once_a_scan():
    _, _, scan, _ = problem()
    first, second = scan_to_int(scan), scan_to_int(scan)
    with span_report() as report:
        a = kernels.scatter_boxes(first, GEOM.nz, GEOM.n, GEOM.nprb)
        b = kernels.scatter_boxes(first, GEOM.nz, GEOM.n, GEOM.nprb)
    assert a is b and count(report, "ops.scan_plan") == 1
    # A solve makes its integer scan anew, and with it the plan.
    with span_report() as report:
        c = kernels.scatter_boxes(second, GEOM.nz, GEOM.n, GEOM.nprb)
    assert torch.equal(a, c) and count(report, "ops.scan_plan") == 1


def test_collectives_are_spans(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        launches = cg.all_reduce.launches
        with span_report() as report:
            x = cg.all_reduce(torch.ones(3), dist.group.WORLD)
            cg.halo_exchange(torch.ones(1, 4, 2), [], 1)
        assert torch.equal(x, torch.ones(3))
        assert count(report, "cg.all_reduce") == 1
        assert cg.all_reduce.launches == launches + 1
        assert count(report, "cg.halo_exchange") == 1
    finally:
        dist.destroy_process_group()


# -- on the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["merged", "joint"])
def test_the_report_on_the_card(dev, body):
    data, psi0, scan, prb = problem(dev, torch.complex64)
    run(data, psi0, scan.clone(), prb, GEOM, piter=2, **BODIES[body])
    with span_report() as report:
        for _ in range(2):
            _, _, m = run(data, psi0, scan.clone(), prb, GEOM, piter=ITERS,
                          **BODIES[body])
    assert count(report, "cg.run") == 2 and len(report.by_root) == 2
    assert count(report, "cg.iteration") == 2 * ITERS
    assert count(report, "cg.host_read") == 2 * m["host_syncs"]
    charged = sum(f.idle_self_s for f in report.by_name.values())
    assert abs(charged + report.idle_unspanned_s - report.idle_s) < 1e-6
    assert 0 < report.busy_s < report.window_s
    assert report.by_name["cg.run"].launches > 2 * ITERS
    # The fused kernels make the tile scatter's box plan once a run.
    assert count(report, "ops.scan_plan") == 2
    for f in report.by_name.values():
        assert 0 <= f.idle_self_s <= f.idle_s <= f.wall_s + 1e-9


@pytest.mark.cuda
def test_a_plain_profile_on_the_card_holds_no_span(dev):
    data, psi0, scan, prb = problem(dev, torch.complex64)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(data, psi0, scan, prb, GEOM, piter=2, kernel="fused_mx")
        torch.cuda.synchronize(dev)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names and not any(profiling.PREFIX in n for n in names)
