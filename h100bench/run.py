"""Run one cell of tikejax_torch's benchmark on this machine's H100.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything it needs lives under ``h100bench/`` and is
found by name (``spec.py``). The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each correctness
number beside its limit, which also close standard error. The run exits
non-zero, printing no result, without the CUDA devices the cell asks for,
without the program in the checkout, or if the process has loaded JAX or
the JAX package.
"""

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from h100bench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
