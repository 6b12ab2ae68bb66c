"""Readings that set a cell's correctness limits, on the card.

    python3 h100bench/calibrate.py --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--out chiprun_out/calibrate]

Each seed is a generator seed: one problem of the cell's configuration,
as a pool member is made. For each seed of ``--seeds`` the program's job
(or solve) runs as the window runs it, after one warm-up, and its answer is
judged against the reference (the lower readings); for each of
``--control-seeds`` the reference itself, in bfloat16, is put in the
program's place and judged the same way (the upper readings). One JSON
line a seed and side, to standard output and to
``<out>/<workload>.jsonl``. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HORIZONS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="chiprun_out/calibrate")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    from h100bench import harness, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load(args.workload)
    program = harness.load_program()
    run = harness.Run(cell, torch.device("cuda", 0), program)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    warm = False
    with open(out / f"{args.workload}.jsonl", "a") as log:
        for seed in sorted(set(seeds) | set(controls), key=seeds.__contains__,
                           reverse=True):
            run.make_problems([seed])
            sides = []
            if seed in seeds:
                if not warm:
                    cell.driver.warm_up(run)
                    warm = True
                cell.driver.unit(run, 0)
                rec = run.records()[-1]
                sides.append(("program", cell.driver.answer(run, 0),
                              {"seconds": rec.seconds, "iters": rec.iters,
                               "evaluations": rec.evaluations,
                               "stages": rec.stages, "final": rec.final,
                               "reached": rec.reached}))
            if seed in controls:
                t = time.perf_counter()
                ans = cell.driver.control_answer(run, 0)
                sides.append(("control", ans,
                              {"seconds": time.perf_counter() - t}))
            for side, ans, info in sides:
                t = time.perf_counter()
                numbers = cell.driver.judge(run, 0, ans, HORIZONS)
                info["judge_s"] = time.perf_counter() - t
                ref = run.solutions.get(0)
                if ref is not None and len(ans) == 3 and \
                        ref.iters == len(ans[2]):
                    # The complex128 reference's own answer, and the last
                    # residual the side itself reported.
                    info["ref_answer_residual"] = cell.reference.residual_at(
                        run.problems[0], ref.psi, ref.prb)
                    info["reported_last"] = ans[2][-1]
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "side": side, "numbers": numbers,
                                   **info})
                print(line, flush=True)
                log.write(line + "\n")
            del sides
    return 0


if __name__ == "__main__":
    sys.exit(main())
