"""A small pool of ranks for runs on a mesh.

``RankPool(n)`` starts ``n`` processes with ``torch.multiprocessing``
(spawn), joins them in one gloo process group through a ``file://`` store in
a temporary directory (no network), and sets each to one intra-op thread
and, with ``device_type='cuda'``, to the card ``rank % cards``
(every rank on ``cuda:0`` where there is one card: NCCL refuses two ranks on
one device, gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``).
The ranks stay up between jobs, so a caller starts the pool once per module
or phase.

``pool.run(fn, *args)`` hands every rank the same job: ``fn(rank, world,
*args)``, where ``fn`` is a function of this package (a child process
imports the module that defines it, never the caller's, so a child never
imports jax) and ``args`` are picklable. It returns every rank's result in
rank order, with each tensor in it as a CPU tensor (results come back
through a pipe as numpy arrays). A rank that raises fails the job with its
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


def _serve(rank, world, store, device_type, collective_timeout, conn):
    """A rank: join the process group, then run jobs until told to stop."""
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=collective_timeout))
    conn.send(("ready", None))
    while True:
        job = conn.recv()
        if job is None:
            break
        fn, args = job
        try:
            conn.send(("ok", _map(fn(rank, world, *args), _to_pipe)))
        except BaseException:  # the traceback goes to the caller
            conn.send(("error", traceback.format_exc()))
    dist.destroy_process_group()
    conn.close()


class RankPool:
    """``n`` gloo ranks in processes of their own (see the module note).

    Args:
      n: the number of ranks (the world size).
      device_type: 'cpu' or 'cuda' (each rank selects its card).
      timeout: seconds a job may take before the pool is stopped and the
        job fails (also the time the ranks have to start).
      collective_timeout: seconds a rank waits in one collective before
        gloo fails it (a rank out of step fails rather than hangs).
    """

    def __init__(self, n: int, device_type: str = "cpu",
                 timeout: float = 300.0, collective_timeout: float = 120.0):
        if n < 1:
            raise ValueError(f"a pool needs at least one rank, got {n}")
        if device_type not in ("cpu", "cuda"):
            raise ValueError(f"device_type must be 'cpu' or 'cuda', got "
                             f"{device_type!r}")
        self.n, self.device_type = n, device_type
        self.timeout, self.collective_timeout = timeout, collective_timeout
        self._procs, self._conns, self._dir = None, None, None
        self.starts = 0  # how many times the ranks were started

    def start(self) -> None:
        """Start the ranks and wait until every one has joined the group
        (a no-op while they are up)."""
        if self._procs is not None:
            return
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="tikejax_ranks_")
        store = os.path.join(self._dir, "store")
        self._procs, self._conns = [], []
        for rank in range(self.n):
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
        self._collect("start", time.monotonic() + self.timeout)

    def run(self, fn, *args, timeout: float | None = None) -> list:
        """``fn(rank, world, *args)`` on every rank; the results in rank
        order (see the module note)."""
        self.start()
        for conn in self._conns:
            conn.send((fn, args))
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        return [_map(r, _from_pipe)
                for r in self._collect(getattr(fn, "__name__", "job"),
                                       deadline)]

    def _collect(self, what: str, deadline: float) -> list:
        """One message from every rank, in rank order; on an error, a dead
        rank or the deadline the pool is stopped and the job fails."""
        results = [None] * self.n
        waiting = dict(zip(self._conns, range(self.n)))
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
        return results

    def close(self, force: bool = False) -> None:
        """Stop the ranks: politely (each leaves the process group) when
        they are idle, at once with ``force`` (a failed or late job, whose
        ranks may wait in a collective that never completes)."""
        if self._procs is None:
            return
        if not force:
            for conn in self._conns:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
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
