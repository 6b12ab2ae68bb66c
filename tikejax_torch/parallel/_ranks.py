"""A small pool of ranks for runs on a mesh, and how a rank joins one.

:func:`join_group` makes this process a rank of the default process group
with the backend the topology decides (:func:`backend_for`): NCCL where
every rank has a card of its own (``device_type='cuda'`` and a world no
larger than the visible cards), gloo otherwise -- for CPU ranks, and for
ranks that share a card, which NCCL refuses (gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` and stages them through the host). A
``cuda`` rank selects its card, ``rank % cards``, before the group is
made. The group's timeout bounds every collective: a rank whose peer
raised or died fails within it instead of waiting the backend's default
(10 minutes for NCCL), and the groups the port makes later take it too
(:func:`group_timeout`).

``RankPool(n)`` starts ``n`` processes with ``torch.multiprocessing``
(spawn), each of which joins through a ``file://`` store in a temporary
directory (no network) and runs at one intra-op thread. The ranks stay up
between jobs, so a caller starts the pool once per module or phase. With
``caller=True`` this process is rank 0 and only ranks 1 to ``n - 1`` are
spawned, as a program's own ranks on the cards of one node are. Ranks
started otherwise (``torchrun``, or a program's own processes) call
:func:`join_group` themselves.

``pool.run(fn, *args)`` hands every rank the same job: ``fn(rank, world,
*args)``, where ``fn`` is a function of this package (a child process
imports the module that defines it, never the caller's, so a child never
imports jax) and ``args`` are picklable. It returns every rank's result in
rank order, with each tensor in it as a CPU tensor (results come back
through a pipe as numpy arrays; rank 0's own, with ``caller``, as it is). A rank that raises fails the job with its
traceback, and a job that outlasts ``timeout`` seconds fails with
``TimeoutError``; either way the pool is stopped at once (no rank is left
waiting in a collective) and started afresh by the next job.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection
import os
import shutil
import tempfile
import threading
import time
import traceback

import numpy as np
import torch


class _Host:
    """A tensor on its way back from a rank: its values as numpy."""

    def __init__(self, array: np.ndarray):
        self.array = array


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _to_pipe(x):
    return _Host(x.detach().cpu().numpy()) if torch.is_tensor(x) else x


def _from_pipe(x):
    return torch.from_numpy(x.array) if isinstance(x, _Host) else x


def backend_for(world: int, device_type: str, cards: int | None = None,
                nccl: bool | None = None) -> str:
    """The backend of a group of ``world`` ranks on ``device_type``:
    ``'nccl'`` where NCCL is built in (``nccl``, by default
    ``torch.distributed.is_nccl_available()``) and every rank has a card of
    its own (``device_type='cuda'`` and ``world <= cards``, by default the
    visible cards), else ``'gloo'``."""
    import torch.distributed as dist

    if device_type != "cuda":
        return "gloo"
    if nccl is None:
        nccl = dist.is_nccl_available()
    if cards is None:
        cards = torch.cuda.device_count()
    return "nccl" if nccl and 0 < world <= cards else "gloo"


def join_group(rank: int, world: int, init_method: str,
               device_type: str | None = None,
               timeout: float = 120.0) -> str:
    """Make this process rank ``rank`` of a default process group of
    ``world`` ranks that meet at ``init_method`` (``file://<path>`` or
    ``tcp://localhost:<port>``), on the backend :func:`backend_for` names;
    a ``cuda`` rank first selects its card, ``rank % cards`` (an NCCL
    group is bound to it and set up at once). ``device_type`` is 'cuda'
    by default where torch sees a card, as :func:`make_mesh`'s is, else
    'cpu'. Every collective on the group fails after ``timeout`` seconds.
    Returns the backend's name."""
    import torch.distributed as dist

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = backend_for(world, device_type)
    extra = {}
    if device_type == "cuda":
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        if backend == "nccl":
            extra["device_id"] = torch.device("cuda", card)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout), **extra)
    return backend


def group_timeout(group=None) -> datetime.timedelta | None:
    """The collective timeout of ``group`` (by default the default group),
    which a new group must be given: torch's new groups take their
    backend's default instead. None where this torch does not show it."""
    import torch.distributed as dist

    group = dist.group.WORLD if group is None else group
    for device in getattr(group, "_device_types", ()):
        try:
            return group._get_backend(device).options._timeout
        except (AttributeError, RuntimeError):
            continue
    return None


def set_group_timeout(group, timeout: datetime.timedelta | None) -> None:
    """Give ``group``, which this rank belongs to, the collective timeout
    ``timeout`` (a no-op for None, or where this torch cannot set it)."""
    import torch.distributed as dist

    setter = getattr(dist.distributed_c10d, "_set_pg_timeout", None)
    if timeout is not None and setter is not None:
        setter(timeout, group)


def _serve(rank, world, store, device_type, collective_timeout, conn):
    """A rank: join the process group, then run jobs until told to stop. A
    job that raises sends its traceback and ends the process, so that the
    ranks waiting for it in a collective fail at once (gloo sees the
    connection close) rather than at the group's timeout."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    join_group(rank, world, f"file://{store}", device_type,
               collective_timeout)
    conn.send(("ready", None))
    while True:
        job = conn.recv()
        if job is None:
            break
        fn, args = job
        try:
            out = _map(fn(rank, world, *args), _to_pipe)
        except BaseException:  # the traceback goes to the caller
            conn.send(("error", traceback.format_exc()))
            conn.close()
            os._exit(1)
        conn.send(("ok", out))
    dist.destroy_process_group()
    conn.close()


def _leave(force: bool) -> None:
    """This process leaves the default process group: at once with
    ``force`` on NCCL (an abort, which also ends a collective in flight;
    a polite leave waits for every rank's)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    if force and dist.get_backend() == "nccl":
        abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
        if abort is not None:
            abort()
        return
    dist.destroy_process_group()


class RankPool:
    """``n`` ranks in processes of their own (see the module note).

    Args:
      n: the number of ranks (the world size).
      device_type: 'cpu' or 'cuda' (each rank selects its card; the
        group is NCCL where each rank has a card of its own, else gloo).
      timeout: seconds a job may take before the pool is stopped and the
        job fails (also the time the ranks have to start).
      collective_timeout: seconds a rank waits in one collective before
        the backend fails it (a rank out of step fails rather than
        hangs).
      caller: this process is rank 0: ``start`` joins it to the group and
        spawns ranks 1 to ``n - 1``, and ``run`` runs its part of every
        job here, where its result stays as it is (tensors on their
        device). While it runs, a rank that ends (it raised or died)
        stops the other ranks and, on NCCL, aborts the group, so that
        this part fails at once instead of waiting in a collective; a
        failure of this part stops the pool. ``timeout`` bounds the other
        ranks once this part is done; the group's timeout bounds this
        part.
    """

    def __init__(self, n: int, device_type: str = "cpu",
                 timeout: float = 300.0, collective_timeout: float = 120.0,
                 caller: bool = False):
        if n < 1:
            raise ValueError(f"a pool needs at least one rank, got {n}")
        if device_type not in ("cpu", "cuda"):
            raise ValueError(f"device_type must be 'cpu' or 'cuda', got "
                             f"{device_type!r}")
        self.n, self.device_type = n, device_type
        self.timeout, self.collective_timeout = timeout, collective_timeout
        self.caller = caller
        self._procs, self._conns, self._dir = None, None, None
        self._ended = None  # the rank whose end the watcher saw first
        self.starts = 0  # how many times the ranks were started

    @property
    def _ranks(self) -> range:
        """The ranks in processes of their own."""
        return range(int(self.caller), self.n)

    def start(self) -> None:
        """Start the ranks and wait until every one has joined the group
        (a no-op while they are up)."""
        if self._procs is not None:
            return
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="tikejax_ranks_")
        store = os.path.join(self._dir, "store")
        self._procs, self._conns = [], []
        for rank in self._ranks:
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(
                target=_serve, daemon=True,
                args=(rank, self.n, store, self.device_type,
                      self.collective_timeout, theirs))
            proc.start()
            theirs.close()
            self._procs.append(proc)
            self._conns.append(mine)
        self.starts += 1
        deadline = time.monotonic() + self.timeout
        if self.caller:
            try:
                join_group(0, self.n, f"file://{store}", self.device_type,
                           self.collective_timeout)
            except BaseException:
                self.close(force=True)
                raise
        self._collect("start", deadline)

    def run(self, fn, *args, timeout: float | None = None) -> list:
        """``fn(rank, world, *args)`` on every rank; the results in rank
        order (see the module note)."""
        self.start()
        for conn in self._conns:
            conn.send((fn, args))
        what = getattr(fn, "__name__", "job")
        mine = [self._here(what, fn, args)] if self.caller else []
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        return mine + [_map(r, _from_pipe)
                       for r in self._collect(what, deadline)]

    def _here(self, what: str, fn, args):
        """Rank 0's part of a job, in this process (``caller``)."""
        self._ended = None
        wake, stop = os.pipe()
        watcher = threading.Thread(target=self._watch, args=(wake,),
                                   daemon=True)
        watcher.start()
        failed = None
        try:
            return fn(0, self.n, *args)
        except Exception:
            failed = traceback.format_exc()
        finally:
            os.write(stop, b"0")
            watcher.join()
            os.close(wake)
            os.close(stop)
        why = self._why() or f"rank 0 failed:\n{failed}"
        self.close(force=True)
        raise RuntimeError(f"{what}: {why}")

    def _watch(self, wake: int) -> None:
        """Until ``wake`` is written: on the end of a rank's process, stop
        the others (gloo's collectives here then fail on the closed
        connections) and on NCCL abort the group (its collectives would
        wait their timeout)."""
        ends = {p.sentinel: rank for p, rank in zip(self._procs,
                                                    self._ranks)}
        ended = [ends[x] for x in multiprocessing.connection.wait(
            [*ends, wake]) if x in ends]
        if ended:
            self._ended = ended[0]
            for proc in self._procs:
                proc.kill()
            import torch.distributed as dist

            if dist.is_initialized() and dist.get_backend() == "nccl":
                _leave(force=True)

    def _why(self) -> str | None:
        """The failure of the rank whose process ended first: the
        traceback it sent, or that it died; None where every rank is up."""
        rank = self._ended
        if rank is None:
            rank = next((r for p, r in zip(self._procs, self._ranks)
                         if not p.is_alive()), None)
        if rank is None:
            return None
        conn = self._conns[rank - self._ranks.start]
        try:
            if conn.poll(1.0):
                status, value = conn.recv()
                if status == "error":
                    return f"rank {rank} failed:\n{value}"
        except (EOFError, OSError):
            pass
        return f"rank {rank} died"

    def _collect(self, what: str, deadline: float) -> list:
        """One message from every rank in a process of its own, in rank
        order; on an error, a dead rank or the deadline the pool is
        stopped and the job fails."""
        results = {}
        waiting = dict(zip(self._conns, self._ranks))
        while waiting:
            left = deadline - time.monotonic()
            ready = multiprocessing.connection.wait(list(waiting),
                                                    max(left, 0.0))
            if not ready:
                self.close(force=True)
                raise TimeoutError(
                    f"{what}: ranks {sorted(waiting.values())} did not "
                    "answer in time; the pool was stopped")
            for conn in ready:
                rank = waiting.pop(conn)
                try:
                    status, value = conn.recv()
                except EOFError:
                    status, value = "error", "the rank's process died"
                if status == "error":
                    self.close(force=True)
                    raise RuntimeError(f"{what}: rank {rank} failed:\n"
                                       f"{value}")
                results[rank] = value
        return [results[rank] for rank in self._ranks]

    def close(self, force: bool = False) -> None:
        """Stop the ranks: politely (each leaves the process group, this
        process too with ``caller``) when they are idle, at once with
        ``force`` (a failed or late job, whose ranks may wait in a
        collective that never completes)."""
        if self._procs is None:
            return
        if not force:
            for conn in self._conns:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        if self.caller:  # NCCL's polite leave waits for every rank's
            _leave(force)
        if not force:
            for proc in self._procs:
                proc.join(timeout=5)
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        self._procs, self._conns, self._dir = None, None, None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
