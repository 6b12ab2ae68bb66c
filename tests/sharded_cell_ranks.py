"""The benchmark's sharded cell at a tiny size on the CPU, in a process of
its own (rank 0 is this process, ranks 1-3 its spawned children):

    python tests/sharded_cell_ranks.py <traced: 0|1> [raises|dies|differs|-]
        [cpu|cuda]

runs ``h100bench.harness.execute`` on ``gauss-512-64k.sharded-x4`` cut to
``h100bench/tests/tiny.py``'s geometry and pool, with the CPU's spelling of
the solver's defaults (``kernel='fused_mx'``), on four gloo CPU ranks (with
``cuda``, on the cards: NCCL where there are four), and
prints one JSON line: the result, the jobs rank 0 ran, the jobs whose
objects it held to every rank's, the ranks still alive and the JAX
modules this process loaded. A fault makes rank 2 raise, die, or
hand back an object that differs from the others' at its first job; the
run must then end non-zero without printing a line.
"""

import dataclasses
import json
import multiprocessing
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "gauss-512-64k.sharded-x4"


def faulty_job(rank, world, k, fault):
    """A rank's part of a job, where rank 2 commits ``fault``."""
    from h100bench.drivers import sharded

    if rank == 2:
        if fault == "raises":
            raise RuntimeError("an injected fault on rank 2")
        if fault == "dies":
            os._exit(3)
        me = sharded._me
        solve = me.parallel.run_sharded

        def run_sharded(*a, **kw):
            psi, prb, m = solve(*a, **kw)
            psi = psi.clone()
            psi.view(-1)[0] += 1
            return psi, prb, m

        me.parallel = types.SimpleNamespace(run_sharded=run_sharded)
    return sharded._me.run(k)


# Module-level, so that a spawned rank finds them by name.
def job_raises(rank, world, k):
    return faulty_job(rank, world, k, "raises")


def job_dies(rank, world, k):
    return faulty_job(rank, world, k, "dies")


def job_differs(rank, world, k):
    return faulty_job(rank, world, k, "differs")


def main(traced: bool, fault: str | None, device: str) -> None:
    import torch

    from h100bench import harness, spec
    from h100bench.drivers import sharded
    from h100bench.tests import tiny

    torch.set_num_threads(1)
    cell = spec.load(CELL)
    cell = dataclasses.replace(
        cell, config=dict(cell.config, **tiny.TINY, pool_seeds=tiny.POOL),
        mix=dict(cell.mix, options={"kernel": "fused_mx"}))
    if fault:
        sharded._job = globals()[f"job_{fault}"]
    runs = []
    warm_up = sharded.warm_up

    def kept(run):
        runs.append(run)
        warm_up(run)

    sharded.warm_up = kept
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    result = harness.execute(cell, tiny.SEED, 0.3, traced, dev,
                             harness.load_program(), time.perf_counter())
    run = runs[0]
    print(json.dumps({"result": result, "jobs": 1 + len(run.jobs)
                      + len(run.profiled_records),
                      "held": sharded._me.checked,
                      "ranks_alive": len(multiprocessing.active_children()),
                      "jax": harness.loaded_jax()}),
          flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    args = sys.argv[1:] + ["-", "cpu"][len(sys.argv) - 2:]
    main(bool(int(args[0])), None if args[1] == "-" else args[1], args[2])
