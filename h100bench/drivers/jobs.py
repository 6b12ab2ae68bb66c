"""Back-to-back jobs: each one ``tikejax_torch.solvers.run`` of
``iters_per_job`` iterations from a problem's start, the wait for one
scan's reconstruction.

The window runs whole cycles of the configuration's pool of problems, each
cycle in an order drawn from the seed. A job runs on a fresh clone of its
problem's scan, made before its timed span: the program keeps plans on the
scan tensor, and a new scan pays for them, as at a beamline. The last
job on each problem is judged: its residual history, object and probe
against the reference solver in complex128, run for the same iterations
from the same inputs.
"""

from __future__ import annotations

import math
import time

from h100bench.reference.ptycho import aligned_max, relative_max


def job(run, k: int, records: list) -> None:
    p, mix = run.problems[k], run.cell.mix
    scan = p.scan.clone()
    run.sync()
    start = time.perf_counter()
    psi, prb, m = run.program.solvers.run(
        p.data, p.psi0, scan, p.prb0, run.geometry,
        piter=mix["iters_per_job"], model=p.model,
        recover_prb=p.recover_prb, **mix["options"])
    run.sync()
    end = time.perf_counter()
    records.append(run.Record(k, start, end, int(m["iters_run"]),
                              m["evaluations"], m["host_syncs"]))
    run.last[k] = (psi, prb, m)


def warm_up(run) -> None:
    job(run, 0, [])


def unit(run, k: int) -> None:
    job(run, k, run.jobs)


def window(run, seconds: float) -> None:
    for k in run.cycles(seconds, run.jobs):
        job(run, k, run.jobs)
    if run.traced:
        with run.profiled():
            for k in run.cycle():
                job(run, k, run.profiled_records)


def answer(run, k: int):
    """The last job's (object, probe, residual history) on problem ``k``;
    drops the program's state there."""
    psi, prb, m = run.last.pop(k)
    n = int(m["iters_run"])
    return psi, prb, m["residual"][:n].double().cpu().tolist()


def control_answer(run, k: int):
    """The reference, put in the program's place, in bfloat16."""
    sol = run.cell.reference.solve(run.problems[k],
                                   run.cell.mix["iters_per_job"], "bf16")
    return sol.psi, sol.prb, sol.residual


def judge(run, k: int, out, horizons=()) -> dict:
    """The numbers of ``out`` on problem ``k`` against the complex128
    reference: ``residual_err``, the widest relative gap of the residual
    histories over their first ``compare['residual_iters']`` iterations
    (all by default; infinite where the histories differ in length there),
    likewise ``residual_err.<n>`` for each ``n`` of ``horizons``;
    ``answer_residual``, the relative residual of the returned object and
    probe in complex128. Where the reference runs the whole job, also
    ``psi_err`` and, with probe recovery, ``prb_err``: ``max|a - b| /
    max|b|`` (with probe recovery each up to its least-squares complex
    scale). The reference runs no further than the numbers need."""
    job = run.cell.mix["iters_per_job"]
    first = run.cell.compare.get("residual_iters", job)
    need = min(job, max([first, *horizons]))
    if k not in run.solutions or run.solutions[k].iters < need:
        run.solutions[k] = run.cell.reference.solve(run.problems[k], need,
                                                     "fp64")
    ref = run.solutions[k]
    psi, prb, res = out

    def gap(n):
        a, b = res[:n], ref.residual[:n]
        if len(a) != len(b):
            return math.inf
        return max(abs(x - y) / y for x, y in zip(a, b))

    numbers = {"residual_err": gap(first),
               "answer_residual": run.cell.reference.residual_at(
                   run.problems[k], psi, prb)}
    for n in horizons:
        numbers[f"residual_err.{n}"] = gap(n)
    if need < job:
        return numbers
    if run.problems[k].recover_prb:
        numbers["psi_err"] = aligned_max(psi, ref.psi)
        numbers["prb_err"] = aligned_max(prb, ref.prb)
    else:
        numbers["psi_err"] = relative_max(psi.to(ref.psi.dtype), ref.psi)
    return numbers
