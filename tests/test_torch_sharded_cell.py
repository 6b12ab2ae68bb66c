"""The benchmark's four-rank cell (``h100bench/drivers/sharded.py``, cell
``gauss-512-64k.sharded-x4``) at a tiny size on four gloo CPU ranks, and
the rule that picks a process group's backend
(``tikejax_torch.parallel.join_group``).

Each run is a process of its own (``tests/sharded_cell_ranks.py``): rank 0
is that process, as the harness's is on the card, and a failing rank ends
it. The run is judged against the benchmark's complex128 reference, every
job's object is held to rank 0's on every rank bit for bit, and a rank
that raises, dies or hands back another object ends the run non-zero well
inside the group's collective timeout. A CPU build of torch has no NCCL:
the backend rule is tested alone.
"""

import datetime
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tests" / "sharded_cell_ranks.py"
sys.path.insert(0, str(ROOT))

from h100bench.drivers import sharded  # noqa: E402
from tikejax_torch.parallel import _jobs, _ranks, backend_for, join_group  # noqa: E402,E501
from tikejax_torch.parallel import make_mesh  # noqa: E402
from tikejax_torch.solvers import cg  # noqa: E402

# Seconds a tiny run may take (5-12 s alone); a hang fails the test.
RUN_TIMEOUT = 240


def tiny_run(*args):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(SCRIPT), *args], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=RUN_TIMEOUT)
    return out, time.perf_counter() - t0


@pytest.mark.parametrize("traced", ["0", "1"])
def test_the_tiny_cell_on_four_gloo_ranks(traced):
    out, _ = tiny_run(traced)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    result = line["result"]
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"psi_err", "residual_err"}
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert result["device"]["count"] == 4
    if traced == "1":
        # Off the card only the program's counter is there to read.
        per_iter = result["metrics"]["cg.all_reduce.per_iter.sharded-x4"]
        assert per_iter["value"] > 0 and per_iter["unit"] == "calls/iter"
    else:
        assert set(result["metrics"]) == {"cg_iters_per_s", "job_s_p90",
                                          "setup_s"}
    # Every job rank 0 ran (warm-up, window, profiled cycle) had every
    # rank's object equal to rank 0's, bit for bit.
    assert line["held"] == line["jobs"] >= 3
    assert "ranks: 4 on gloo" in out.stderr and line["ranks_alive"] == 0
    assert line["jax"] == []


@pytest.mark.parametrize("fault, said", [
    ("raises", "an injected fault on rank 2"),
    ("dies", "rank 2 died"),
    ("differs", "differ from rank 0's in 1 words"),
])
def test_a_failing_rank_ends_the_run(fault, said):
    out, seconds = tiny_run("0", fault)
    assert out.returncode != 0, out.stderr[-3000:]
    assert out.stdout == "" and said in out.stderr
    assert f"RuntimeError: job_{fault}: rank " in out.stderr
    assert seconds < sharded.TIMEOUT


@pytest.mark.parametrize("world, device_type, cards, nccl, backend", [
    (4, "cuda", 4, True, "nccl"),   # a card a rank
    (1, "cuda", 1, True, "nccl"),
    (4, "cuda", 8, True, "nccl"),
    (4, "cuda", 1, True, "gloo"),   # ranks share a card: NCCL refuses
    (2, "cuda", 1, True, "gloo"),
    (4, "cpu", 4, True, "gloo"),    # CPU ranks
    (4, "cuda", 4, False, "gloo"),  # a torch without NCCL
])
def test_the_backend_follows_the_topology(world, device_type, cards, nccl,
                                          backend):
    assert backend_for(world, device_type, cards, nccl) == backend


@pytest.mark.parametrize("card", [True, False])
def test_a_rank_joins_on_its_card_where_there_is_one(card, monkeypatch):
    """``join_group`` with no ``device_type``: on a machine with cards a
    rank selects its own and an NCCL group is bound to it; without, a CPU
    rank on gloo."""
    import torch.distributed as dist

    made = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4 if card else 0)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: made.setdefault("card", i))
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: made.update(backend=backend,
                                                          **kw))
    backend = join_group(2, 4, "file:///nowhere")
    assert backend == made["backend"] == ("nccl" if card else "gloo")
    assert made["world_size"] == 4 and made["rank"] == 2
    if card:
        assert made["card"] == 2
        assert made["device_id"] == torch.device("cuda", 2)
    else:
        assert "card" not in made and "device_id" not in made


def test_a_pool_with_the_caller_as_rank_0():
    """``RankPool(caller=True)``: this process is rank 0 and runs its part
    here; a rank that raises while rank 0 waits for it in a collective
    fails the job at once, not at the group's timeout, and the next job
    starts the pool afresh."""
    import torch.distributed as dist

    pool = _ranks.RankPool(3, "cpu", timeout=60, collective_timeout=45,
                           caller=True)
    try:
        assert pool.run(_jobs.stall, 0.0) == [3.0, 3.0, 3.0]
        assert dist.get_rank() == 0 and dist.get_world_size() == 3
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match=r"stall: rank [12] failed"
                           r"(.|\n)*TypeError"):
            pool.run(_jobs.stall, "no time")  # ranks 1, 2 raise in sleep
        assert time.perf_counter() - t0 < 20
        assert not dist.is_initialized()
        assert pool.run(_jobs.stall, 0.0) == [3.0, 3.0, 3.0]
        assert pool.starts == 2
    finally:
        pool.close()
    assert not dist.is_initialized()


def test_a_torch_without_nccl_takes_gloo():
    assert backend_for(1, "cpu") == "gloo"
    if not torch.distributed.is_nccl_available():
        assert backend_for(4, "cuda", cards=4) == "gloo"


def test_every_group_takes_the_default_groups_timeout(tmp_path):
    import torch.distributed as dist

    assert join_group(0, 1, f"file://{tmp_path}/pg", "cpu",
                      timeout=77) == "gloo"
    try:
        want = datetime.timedelta(seconds=77)
        assert _ranks.group_timeout() == want
        mesh = make_mesh((1, 1), device_type="cpu")
        for dim in range(2):
            assert _ranks.group_timeout(mesh.get_group(dim)) == want
        # A group the solver makes over two mesh dimensions, and a halo
        # pair group: torch's own default would be 30 minutes on gloo.
        assert _ranks.group_timeout(
            cg._mesh_groups(mesh, ("theta", "scan"))) == want
        bare = dist.new_group([0])
        assert _ranks.group_timeout(bare) != want
        _ranks.set_group_timeout(bare, want)
        assert _ranks.group_timeout(bare) == want
    finally:
        dist.destroy_process_group()


def test_the_checksum_sees_every_word():
    x = torch.arange(1000, dtype=torch.float32).reshape(10, 100)
    y = x.clone()
    assert sharded.checksum(x) == sharded.checksum(y)
    y[3, 7], y[3, 8] = x[3, 8], x[3, 7]  # two words swapped
    assert sharded.checksum(x) != sharded.checksum(y)
    z = torch.polar(torch.ones(5, 4), torch.rand(5, 4))
    w = z.clone()
    w.view(-1)[2] = -w.view(-1)[2]
    assert sharded.checksum(z) != sharded.checksum(w)
    # Past one chunk of words, and no int64 overflow for the top words.
    big = torch.full((sharded.CHUNK + 5,), -1, dtype=torch.int32)
    assert sharded.checksum(big.view(torch.float32)) == (
        -sum(i % 251 + 1 for i in range(big.numel()))) % 2**64
