"""The span readers: nothing off the card, the right share of a synthetic
report, and the re-run under the program's span report leaving the run's
records and answers as they were."""

import types

import pytest
import torch

from h100bench import harness, spans
from h100bench.tests import tiny
from h100bench.tests.test_h100bench_metrics import reader

NAMES = ["cg.line_search.idle_share.jobs", "cg.setup.idle_share.jobs",
         "cg.direction.idle_share.deep",
         "cg.direction.launches_per_iter.deep",
         "tiered.self.idle_share.deep"]


@pytest.mark.parametrize("name", NAMES)
def test_nothing_off_the_card(name):
    run = types.SimpleNamespace(on_card=False, jobs=[], solves=[])
    assert reader(name).read(run) is None
    assert run.span_report is None


def figures(count, wall_s, idle_s, launches=0):
    return types.SimpleNamespace(count=count, wall_s=wall_s, idle_s=idle_s,
                                 launches=launches)


# A synthetic report: two jobs of 0.5 s summed, or a solve of 10 s.
REPORT = types.SimpleNamespace(by_name={
    "cg.run": figures(2, 0.5, 0.1),
    "cg.setup": figures(2, 0.02, 0.004),
    "cg.line_search": figures(64, 0.2, 0.06),
    "tiered.reconstruct": figures(1, 10.0, 2.5),
    "cg.iteration": figures(1000, 9.0, 2.0),
    "cg.direction": figures(1000, 3.0, 1.2, launches=130_000),
})
EXPECTED = {"cg.line_search.idle_share.jobs": 100 * 0.06 / 0.5,
            "cg.setup.idle_share.jobs": 100 * 0.004 / 0.5,
            "cg.direction.idle_share.deep": 100 * 1.2 / 10.0,
            "cg.direction.launches_per_iter.deep": 130.0,
            "tiered.self.idle_share.deep": 100 * (2.5 - 0.1) / 10.0}


@pytest.mark.parametrize("name", NAMES)
def test_the_share_of_a_synthetic_report(name):
    run = types.SimpleNamespace(on_card=True, span_report=REPORT)
    assert reader(name).read(run) == pytest.approx(EXPECTED[name])


def test_a_span_the_report_lacks_reads_zero_and_a_base_it_lacks_none():
    rep = types.SimpleNamespace(by_name={"cg.run": figures(1, 0.5, 0.1)})
    run = types.SimpleNamespace(on_card=True, span_report=rep)
    assert reader("cg.line_search.idle_share.jobs").read(run) == 0.0
    assert reader("cg.direction.idle_share.deep").read(run) is None
    assert reader("cg.direction.launches_per_iter.deep").read(run) is None


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_rerun_leaves_the_run_as_it_was(name):
    torch.manual_seed(0)
    run = harness.Run(tiny.cell(name), torch.device("cpu"),
                      harness.load_program(), traced=True, seed=tiny.SEED)
    run.make_problems(run.cell.config["pool_seeds"])
    run.cell.driver.warm_up(run)
    run.cell.driver.window(run, 0.3)
    records, last = list(run.records()), dict(run.last)
    rep = spans._rerun(run)
    assert run.records() == records
    assert run.last.keys() == last.keys()
    assert all(run.last[k] is last[k] for k in last)
    roots = "cg.run" if run.jobs else "tiered.reconstruct"
    assert [s.name for s in rep.spans if s.parent is None] == (
        [roots] * len(run.profiled_records))
    assert rep.idle_s is None  # off the card
