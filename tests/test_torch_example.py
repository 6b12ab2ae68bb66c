"""The port's example, ``examples/reconstruct_torch.py``, on the CPU at a
tiny size: a fixed-count run with a checkpoint, and the deep-residual
driver."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from tikejax_torch.utils import checkpoint  # noqa: E402

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / (
    "reconstruct_torch.py")
TINY = ["--size", "48", "--nscan", "16", "--ndet", "16", "--nprb", "12",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("reconstruct_torch",
                                                  EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield module
    torch.set_num_threads(n)


def test_fixed_count_run_with_checkpoint(example, tmp_path, capsys):
    path = tmp_path / "state.npz"
    err = example.main(TINY + ["--piter", "12", "--checkpoint", str(path)])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "iters/s" in out
    assert "iter       minf" in out and f"saved state to {path}" in out
    assert 0.0 <= err < 1.0
    state = checkpoint.load(str(path), device="cpu")
    assert state["psi"].shape == (1, 48, 48)
    assert int(state["metrics"]["iters_run"]) >= 1


def test_deep_residual_driver_poisson_joint(example, capsys):
    err = example.main(TINY + ["--target", "1e-3", "--model", "poisson",
                               "--recover-prb", "--photons", "1e4"])
    out = capsys.readouterr().out
    assert "stage" in out and "stages in" in out
    assert 0.0 <= err < 1.0
