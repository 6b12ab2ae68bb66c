"""The end-to-end arithmetic on synthetic timings, and the readers of the
counters."""

import types

import pytest

from h100bench import spec, stats
from h100bench.harness import Record, Run
from h100bench.tests.tiny import CELLS


def window(records):
    run = types.SimpleNamespace(jobs=records, solves=[], profile=None,
                                on_card=False, setup_s=12.5)
    run.records = lambda: records
    run.window_s = Run.window_s.fget(run)
    return run


def reader(name):
    for cell in CELLS:
        for m, _, r in spec.load(cell).end_to_end + spec.load(cell).per_layer:
            if m == name:
                return r
    raise KeyError(name)


def jobs_with_a_stall():
    # 20 jobs of 0.2 s back to back, 32 iterations each; the 10th waits
    # 3 s before it starts, and the 15th takes 1.2 s.
    out, t = [], 100.0
    for i in range(20):
        if i == 10:
            t += 3.0
        length = 1.2 if i == 15 else 0.2
        out.append(Record(i % 4, t, t + length, 32, 34, 35))
        t += length + 0.001
    return out


def test_rate_is_all_the_work_over_all_the_window():
    recs = jobs_with_a_stall()
    run = window(recs)
    wall = recs[-1].end - recs[0].start
    assert run.window_s == pytest.approx(wall)
    value = reader("cg_iters_per_s").read(run)
    assert value == pytest.approx(20 * 32 / wall)
    # The stall and the slow job count: not the mean of per-job rates.
    assert value < 32 / 0.2 * 0.5


def test_p90_is_over_every_job():
    recs = jobs_with_a_stall()
    value = reader("job_s_p90").read(window(recs))
    times = sorted(r.seconds for r in recs)
    assert times[16] <= value <= times[-1]
    assert value == pytest.approx(stats.percentile([r.seconds for r in recs],
                                                   90))
    # The 1.2 s job sits past the 90th percentile of 20 jobs.
    assert value < 1.2


def test_counters_per_iteration():
    run = window(jobs_with_a_stall())
    assert reader("cg.evals_per_iter.jobs").read(run) == pytest.approx(34 / 32)
    assert reader("cg.host_syncs_per_iter.jobs").read(run) == \
        pytest.approx(35 / 32)
    assert reader("setup_s").read(run) == 12.5


def test_solve_readers():
    solves = [Record(0, 0.0, 10.0, 1000, 1040, 1100),
              Record(1, 10.0, 21.0, 1013, 1050, 1120)]
    run = types.SimpleNamespace(jobs=[], solves=solves, profile=None,
                                on_card=False)
    assert reader("time_to_target_s").read(run) == pytest.approx(10.5)
    assert reader("tiered.iters_per_solve.deep").read(run) == \
        pytest.approx(1006.5)
    # Nothing of a job window to read in a cell of solves, and no device
    # share without a profile.
    for name in ("cg_iters_per_s", "job_s_p90", "cg.evals_per_iter.jobs",
                 "device.idle_share.deep", "device.idle_share.jobs",
                 "kernel.grad_fused.roofline.jobs"):
        assert reader(name).read(run) is None


def test_idle_share_against_the_unprofiled_time():
    recs = jobs_with_a_stall()
    run = window(recs)
    # A profiled cycle of the four problems, which took 0.2 s each in the
    # window (0.4 s on average for problem 3, with its 1.2 s job), 1.4 s
    # under the profiler, the card busy 0.75 s of it.
    run.profiled_records = [Record(k, 0.0, 0.35, 32, 34, 35)
                            for k in range(4)]
    run.unprofiled_s = lambda: Run.unprofiled_s(run)
    run.profile = types.SimpleNamespace(busy_s=0.75, window_s=1.4)
    assert run.unprofiled_s() == pytest.approx(0.2 * 3 + 0.4)
    assert reader("device.idle_share.jobs").read(run) == pytest.approx(
        100 * (1 - 0.75 / 1.0))
