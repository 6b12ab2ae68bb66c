"""Position-sharded jobs on one host's cards: each job one
``tikejax_torch.parallel.run_sharded`` of ``iters_per_job`` iterations on a
``('scan',)`` mesh of ``ranks`` ranks from a problem's start, the wait for
one scan's reconstruction when its positions are split over the cards.

The ranks are the port's ``parallel.RankPool`` with this process as rank
0 (``caller``), on the run's device, so that the harness's clock, its
profiler window, the span report and the judge run here as they do for
the jobs driver. ``warm_up`` starts ranks 1 to ``ranks - 1`` as
``torchrun`` would, rank ``r`` on card ``r`` (all on the CPU off the
card), in a process group on the backend the port picks (NCCL where each
rank has a card of its own, gloo otherwise); every rank makes its mesh
with ``parallel.make_mesh``. Each of ranks 1 on makes every pool problem
from its seed on its own device with ``h100bench/problem.py`` and keeps
only its slice of the positions, one problem at a time. Rank 0 keeps its
slices of the pool the harness made; the warm-up checks once that every
rank's slices equal rank 0's pool at the same positions bit for bit
(checksums of the bits), then drops the rest of the pool, so that each
card holds what a card of the deployment holds, and runs one job. The
judge remakes each problem from its seed.

A job: rank 0 names the member to the other ranks (the pool's pipe,
before the timed span); every rank clones its scan slice; a barrier; rank
0 synchronises and starts its clock; every rank runs ``run_sharded`` on
its slice with the solver's defaults and the mix's ``options``; rank 0
synchronises and stops its clock. Then, outside the timed span, every
rank's object is held to rank 0's bit for bit (rank 0's broadcast,
compared on each rank, the differing words summed over the mesh): a
difference fails the run. Each record carries the ``cg.all_reduce``
launches rank 0 made in the job (``all_reduces``). ``answer`` and
``judge`` are the jobs driver's.

A rank that raises or dies fails the job: the pool stops every rank at
once and raises, and the run ends non-zero (``TIMEOUT``, the group's
collective timeout, is the backstop). The ranks leave once the last job
has run, at the first member judged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from h100bench import problem as _problem
from h100bench.drivers import jobs

TIMEOUT = 120.0  # seconds a collective may wait for a peer
START_S = 900.0  # seconds the ranks have to start and make their slices
CHUNK = 1 << 22  # words a checksum sums at once (no int64 overflow)

answer = jobs.answer


@dataclasses.dataclass
class Slice:
    """One rank's part of one pool problem."""
    data: torch.Tensor
    scan: torch.Tensor
    psi0: torch.Tensor
    prb0: torch.Tensor


def checksum(x: torch.Tensor) -> int:
    """``sum_i (i % 251 + 1) * w_i`` over the 32-bit words ``w_i`` of
    ``x``'s bits, modulo 2^64: equal bits give equal sums on any device."""
    if x.is_complex():
        x = torch.view_as_real(x)
    words = x.contiguous().view(-1).view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for a in range(0, words.numel(), CHUNK):
        w = words[a:a + CHUNK].to(torch.int64)
        weight = torch.arange(a, a + w.numel(), device=w.device) % 251 + 1
        total += torch.sum(w * weight)  # wraps modulo 2^64
    return int(total) % 2**64


def checksums(s: Slice) -> tuple[int, ...]:
    return tuple(checksum(x) for x in (s.data, s.scan, s.psi0, s.prb0))


def _slice(p, rank: int, world: int) -> Slice:
    """Rank ``rank``'s slice of problem ``p``: views of its positions."""
    per = p.scan.shape[1] // world
    part = slice(rank * per, (rank + 1) * per)
    return Slice(p.data[:, part], p.scan[:, part], p.psi0, p.prb0)


class _Rank:
    """What every rank holds: the mesh, its slices of the pool, and its
    part of a job."""

    def __init__(self, rank: int, world: int, config: dict, mix: dict,
                 device: torch.device):
        from tikejax_torch import parallel
        from tikejax_torch.geometry import Geometry
        from tikejax_torch.solvers import cg

        self.rank, self.world, self.config, self.mix = rank, world, config, mix
        self.device, self.cg, self.parallel = device, cg, parallel
        self.geometry = Geometry(**{k: config[k]
                                    for k in _problem.GEOMETRY})
        if config["nscan"] % world:
            raise ValueError(f"{config['nscan']} positions do not split "
                             f"over {world} ranks")
        self.mesh = None
        self.slices: list[Slice] = []
        self.clock = None  # rank 0's: called at the timed span's ends
        self.checked = 0  # jobs whose objects were held to rank 0's

    def make_slices(self) -> None:
        """This rank's slice of every pool problem, made from its seed one
        problem at a time."""
        for seed in self.config["pool_seeds"]:
            s = _slice(_problem.make(self.config, seed, self.device),
                       self.rank, self.world)
            self.slices.append(Slice(s.data.clone(), s.scan.clone(),
                                     s.psi0, s.prb0))

    def run(self, k: int):
        """This rank's part of a job on member ``k``: on rank 0 (psi, prb,
        metrics, its all-reduces in the timed span), else None."""
        s, mix = self.slices[k], self.mix
        scan = s.scan.clone()
        torch.distributed.barrier()
        if self.clock:
            self.clock()
        before = self.cg.all_reduce.launches
        psi, prb, m = self.parallel.run_sharded(
            s.data, s.psi0, scan, s.prb0, self.geometry, self.mesh,
            piter=mix["iters_per_job"], model=self.config["model"],
            recover_prb=self.config["recover_prb"], **mix["options"])
        if self.clock:
            self.clock()
        count = self.cg.all_reduce.launches - before
        self.hold(psi)
        return (psi, prb, m, count) if self.rank == 0 else None

    def hold(self, psi: torch.Tensor) -> None:
        """Hold every rank's ``psi`` to rank 0's bit for bit: rank 0
        broadcasts its words, each rank counts the words that differ, the
        counts are summed over the mesh and rank 0 raises on any."""
        dist = torch.distributed
        mine = torch.view_as_real(psi.contiguous()).view(torch.int32)
        theirs = mine if self.rank == 0 else torch.empty_like(mine)
        dist.broadcast(theirs, src=0)
        differ = torch.sum(theirs != mine).reshape(1).to(torch.int64)
        dist.all_reduce(differ)
        if self.rank == 0:
            n = int(differ)
            if n:
                raise RuntimeError(f"the ranks' objects differ from rank "
                                   f"0's in {n} words after a job")
            self.checked += 1


_me: _Rank | None = None  # this process's rank of the cell


# -- the pool's jobs, on every rank -------------------------------------


def _join(rank: int, world: int, config: dict, mix: dict, device_type: str):
    """Every rank's start: its mesh, and on ranks 1 on its slices made from
    the seeds (rank 0's were set by ``warm_up``); their checksums."""
    global _me
    if rank:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if device_type == "cuda" else torch.device("cpu"))
        _me = _Rank(rank, world, config, mix, device)
        _me.make_slices()
    _me.mesh = _me.parallel.make_mesh(world, device_type=device_type)
    return [checksums(s) for s in _me.slices] if rank else None


def _job(rank: int, world: int, k: int):
    return _me.run(k)


# -- rank 0 -------------------------------------------------------------


def warm_up(run) -> None:
    global _me
    from tikejax_torch import parallel

    config, mix = run.cell.config, run.cell.mix
    world = mix["ranks"]
    _me = _Rank(0, world, config, mix, run.device)
    _me.slices = [_slice(p, 0, world) for p in run.problems]
    run.ranks = parallel.RankPool(world, run.device.type, timeout=START_S,
                                  collective_timeout=TIMEOUT, caller=True)
    got = run.ranks.run(_join, config, mix, run.device.type)
    run.note(f"ranks: {world} on {torch.distributed.get_backend()}")
    for rank in range(1, world):
        want = [checksums(_slice(p, rank, world)) for p in run.problems]
        if got[rank] != want:
            run.ranks.close(force=True)
            raise RuntimeError(f"rank {rank}'s slices differ from rank 0's "
                               f"pool at its positions (checksums "
                               f"{got[rank]} against {want})")
    _me.slices = [Slice(s.data.clone(), s.scan.clone(), s.psi0, s.prb0)
                  for s in _me.slices]
    run.problems = [None] * len(run.problems)
    job(run, 0, [])


def job(run, k: int, records: list) -> None:
    times = []

    def clock():
        run.sync()
        times.append(time.perf_counter())

    _me.clock = clock
    psi, prb, m, count = run.ranks.run(_job, k)[0]
    rec = run.Record(k, times[0], times[1], int(m["iters_run"]),
                     m["evaluations"], m["host_syncs"])
    rec.all_reduces = count
    records.append(rec)
    run.last[k] = (psi, prb, m)


def unit(run, k: int) -> None:
    job(run, k, run.jobs)


def window(run, seconds: float) -> None:
    for k in run.cycles(seconds, run.jobs):
        job(run, k, run.jobs)
    if run.traced:
        with run.profiled():
            for k in run.cycle():
                job(run, k, run.profiled_records)


@contextlib.contextmanager
def _problem_of(run, k: int):
    """``run.problems[k]`` remade from its seed while the body runs, where
    the warm-up dropped it; no job runs after, so the ranks leave first."""
    run.ranks.close()
    if run.problems[k] is not None:
        yield
        return
    run.problems[k] = _problem.make(run.cell.config,
                                    run.cell.config["pool_seeds"][k],
                                    run.device)
    try:
        yield
    finally:
        run.problems[k] = None


def control_answer(run, k: int):
    with _problem_of(run, k):
        return jobs.control_answer(run, k)


def judge(run, k: int, out, horizons=()) -> dict:
    with _problem_of(run, k):
        return jobs.judge(run, k, out, horizons)
