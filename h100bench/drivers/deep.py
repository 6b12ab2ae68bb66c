"""Back-to-back solves: each one ``tikejax_torch.solvers.reconstruct`` to
``target_residual`` with its defaults, from a problem's start: the time to
a reconstruction of stated accuracy.

The window runs whole cycles of the configuration's pool of problems, each
cycle in an order drawn from the seed; a solve runs on a fresh clone of
its problem's scan, made before its timed span. The last answer on each
problem is judged by what it says: the relative residual of the object
(and probe) it returned, computed again by the reference in complex128,
against the target the configuration states.
"""

from __future__ import annotations

import time

# The control's iteration budget: a bfloat16 solver stalls long before it.
CONTROL_ITERS = 256
# The warm-up: the same stages, kernels and shapes as a solve, a few
# iterations each (stage 1, then three refinement segments, so that the
# Anderson step runs).
WARM = dict(segment=4, max_segments=3)
WARM_STAGE1 = 8


def solve(run, k: int, records: list, **kw) -> None:
    p, mix = run.problems[k], run.cell.mix
    scan = p.scan.clone()
    run.sync()
    start = time.perf_counter()
    psi, prb, stages = run.program.solvers.reconstruct(
        p.data, p.psi0, scan, p.prb0, run.geometry,
        target_residual=mix["target_residual"], model=p.model,
        recover_prb=p.recover_prb, **mix["options"], **kw)
    run.sync()
    end = time.perf_counter()
    iters = [int(m["iters_run"]) for _, m in stages]
    final = float(stages[-1][1]["residual"][max(iters[-1] - 1, 0)])
    records.append(run.Record(
        k, start, end, sum(iters), sum(m["evaluations"] for _, m in stages),
        sum(m["host_syncs"] for _, m in stages), iters, final,
        final <= mix["target_residual"]))
    run.last[k] = (psi, prb)


def warm_up(run) -> None:
    kernel, floor, _ = run.program.solvers.tiered.DEFAULT_TIERS[0]
    solve(run, 0, [], tiers=((kernel, floor, WARM_STAGE1),), **WARM)
    run.last.clear()


def unit(run, k: int) -> None:
    solve(run, k, run.solves)


def window(run, seconds: float) -> None:
    for k in run.cycles(seconds, run.solves):
        solve(run, k, run.solves)
    if run.traced:
        with run.profiled():
            solve(run, run.cycle()[0], run.profiled_records)


def answer(run, k: int):
    """The last solve's (object, probe) on problem ``k``; drops the
    program's state there."""
    return run.last.pop(k)


def control_answer(run, k: int):
    """The reference solver, put in the program's place, in bfloat16."""
    sol = run.cell.reference.solve(run.problems[k], CONTROL_ITERS, "bf16",
                                   run.cell.mix["target_residual"])
    return sol.psi, sol.prb


def judge(run, k: int, out, horizons=()) -> dict:
    """``residual``: the relative residual of the answer in complex128."""
    psi, prb = out
    return {"residual": run.cell.reference.residual_at(run.problems[k], psi,
                                                       prb)}
