"""The port's profiling hooks against ``tikejax.utils.profiling``: the same
names exported from ``utils``, the same convergence table for the same
metrics, a timer of the same shape, and a trace that writes a file."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

import tikejax.utils as jutils
import tikejax_torch.utils as tutils
from tikejax_torch.utils import profiling

NAMES = ["Timer", "trace", "summarize_metrics", "device_sync",
         "sync_overhead_seconds"]


@pytest.mark.parametrize("name", NAMES)
def test_utils_exports_the_reference_names(name):
    assert name in jutils.__all__ and name in tutils.__all__
    assert getattr(tutils, name) is getattr(profiling, name)


@pytest.mark.parametrize("every", [1, 3, 7])
def test_summarize_metrics_is_the_reference_table(every):
    rng = np.random.default_rng(0)
    metrics = {"minf": rng.random(20) * 1e3 - 200, "gamma": rng.random(20),
               "grad_norm": rng.random(20) * 1e-2}
    ref = jutils.summarize_metrics(
        {k: jnp.asarray(v, jnp.float32) for k, v in metrics.items()}, every)
    as_tensors = {k: torch.from_numpy(v.astype(np.float32))
                  for k, v in metrics.items()}
    assert tutils.summarize_metrics(as_tensors, every) == ref
    # A facade's metrics are numpy arrays already.
    as_numpy = {k: v.astype(np.float32) for k, v in metrics.items()}
    assert tutils.summarize_metrics(as_numpy, every) == ref
    assert len(ref.splitlines()) == 1 + len(range(0, 20, every))


def test_timer_times_named_sections():
    timer, ref = tutils.Timer(), jutils.Timer()
    for t in (timer, ref):
        with t("a"):
            time.sleep(0.02)
        with t("b"):
            pass
    assert set(timer.times) == set(ref.times) == {"a", "b"}
    assert 0.02 <= timer.times["a"] < 1.0 and timer.times["b"] < 0.02
    with pytest.raises(KeyError):
        with timer("c"):
            raise KeyError("inside")
    assert "c" in timer.times  # recorded even when the section raises


def test_timer_synchronises_at_both_ends_when_the_card_is_in_use(
        monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize",
                        lambda: calls.append(time.perf_counter()))
    timer = tutils.Timer()
    with timer("x"):
        inside = time.perf_counter()
    assert len(calls) == 2 and calls[0] <= inside <= calls[1]
    tutils.device_sync(torch.zeros(1))  # the argument is accepted
    assert len(calls) == 3
    assert tutils.sync_overhead_seconds() >= 0.0 and len(calls) == 5


def test_no_card_means_no_synchronise(monkeypatch):
    def fail():
        raise AssertionError("synchronised without a card in use")

    monkeypatch.setattr(profiling, "_cuda_in_use", lambda: False)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", fail)
    tutils.device_sync()
    assert 0.0 <= tutils.sync_overhead_seconds() < 0.1
    with tutils.Timer()("cpu"):
        pass


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace" / "run0"
    with tutils.trace(str(logdir)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in row.key for row in prof.key_averages())
