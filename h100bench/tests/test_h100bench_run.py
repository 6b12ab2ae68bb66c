"""Each cell driven end to end at a tiny size through the program's plain
kernels on the CPU; the entry point without a card, and without the
program."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench import spec
from h100bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_a_tiny_run_is_correct(name, traced):
    result = tiny.execute(name, traced=traced)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    json.dumps(result, allow_nan=False)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    cell = spec.load(name)
    wanted = cell.per_layer if traced else cell.end_to_end
    # Off the card only the host's and the program's own numbers exist:
    # no device time, no roofline.
    device_only = {m for m, _, _ in wanted
                   if m.startswith(("kernel.", "device."))}
    assert set(result["metrics"]) == {m for m, _, _ in wanted} - device_only
    for m in result["metrics"].values():
        assert m["value"] > 0
    assert set(result["checks"]) == set(cell.limits)


def test_same_seed_same_inputs():
    from h100bench import problem

    config = tiny.cell(tiny.CELLS[0]).config
    a = problem.make(config, tiny.SEED, "cpu")
    b = problem.make(config, tiny.SEED, "cpu")
    c = problem.make(config, tiny.SEED + 1, "cpu")
    assert torch.equal(a.data, b.data) and torch.equal(a.scan, b.scan)
    assert not torch.equal(a.data, c.data)


def test_the_seed_orders_whole_cycles_of_the_pool():
    from h100bench.harness import Record, Run

    def members(seed):
        run = Run(tiny.cell(tiny.CELLS[0]), torch.device("cpu"), None,
                  seed=seed)
        run.problems = [None] * 4
        recs = []
        for k in run.cycles(3.5, recs):
            recs.append(Record(k, float(len(recs)), len(recs) + 1.0, 1, 1,
                               1))
        return [r.member for r in recs]

    a, b = members(tiny.SEED), members(tiny.SEED + 1)
    assert a == members(tiny.SEED) and a != b
    assert len(a) == 4  # the cycle that starts inside the window ends
    assert sorted(a) == sorted(b) == [0, 1, 2, 3]


def test_the_window_ends_within_one_cycle_of_its_length():
    from h100bench.harness import Record, Run

    run = Run(tiny.cell(tiny.CELLS[0]), torch.device("cpu"), None)
    run.problems = [None] * 4
    recs = []
    for k in run.cycles(10.0, recs):
        recs.append(Record(k, float(len(recs)), len(recs) + 1.0, 1, 1, 1))
    # Cycles of 4 s: a third would end at 12 s, past the 10 s asked for.
    assert len(recs) == 8
    # One cycle runs where a cycle is longer than the window.
    recs = []
    for k in run.cycles(3.0, recs):
        recs.append(Record(k, float(len(recs)), len(recs) + 1.0, 1, 1, 1))
    assert len(recs) == 4


def test_a_cell_without_a_memory_reckoning_runs(capsys):
    import dataclasses
    import time

    from h100bench import harness

    cell = dataclasses.replace(tiny.cell(tiny.CELLS[0]), device_bytes=None)
    result = harness.execute(cell, tiny.SEED, 0.3, False,
                             torch.device("cpu"), harness.load_program(),
                             time.perf_counter())
    assert result["correct"], result["checks"]
    assert "reckoned not reckoned" in capsys.readouterr().err


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", tiny.CELLS[0],
         "--seed", str(tiny.SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(spec.ROOT, env)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    # Past the card's check, the program has to be the checkout's own.
    probe = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from h100bench import harness; harness.load_program()"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert probe.returncode != 0 and "tikejax_torch" in probe.stderr
