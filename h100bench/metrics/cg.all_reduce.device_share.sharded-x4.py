"""cg.all_reduce.device_share.sharded-x4: the card's time in the kernels
launched inside the span ``cg.all_reduce`` on rank 0 (the span report's
``device_s``: NCCL's kernels, rank 0's wait for the slowest card included)
over the jobs' summed ``cg.run`` wall time, in %, from the program's span
report of the profiled cycle (``h100bench.spans``). None where the program's
report has no ``device_s``."""

from h100bench import spans


def read(run):
    rep = spans.report(run)
    if rep is None or "cg.run" not in rep.by_name:
        return None
    f = rep.by_name.get("cg.all_reduce")
    device = getattr(f, "device_s", None) if f is not None else 0.0
    if device is None:
        return None
    return 100.0 * device / rep.by_name["cg.run"].wall_s
