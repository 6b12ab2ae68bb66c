"""A run with the timed path broken underneath comes out not correct.

Each cell drives one card, so the exchange between chips has no fault to
plant here. The faults: a step that returns its state unchanged (the
gradient kernels return zeros, so no step moves); half of the positions
left out (the solver sees the first half of the scan and its frames, its
objective normalised over them); an answer altered where it is produced
(one pixel of every object gradient the kernel returns, and of the object
the solver returns, moved by a tenth of its largest value); and, in the
cells whose numbers judge the returned object and probe, those alone
altered so."""

import pytest
import torch

from h100bench.harness import load_program
from h100bench.tests import tiny

PROGRAM = load_program()


def zero_gradients(monkeypatch):
    fused = PROGRAM.fused
    for name in ("grad_fused", "grad_prb_fused"):
        real = getattr(fused, name)

        def broken(*a, _real=real, **k):
            grad, f = _real(*a, **k)
            return torch.zeros_like(grad), f

        monkeypatch.setattr(fused, name, broken)


def half_the_positions(monkeypatch):
    solvers = PROGRAM.solvers
    for name in ("run", "reconstruct"):
        real = getattr(solvers, name)

        def broken(data, psi0, scan, prb0, geometry, *a, _real=real, **k):
            half = geometry.nscan // 2
            g = type(geometry)(**{**geometry.__dict__, "nscan": half})
            return _real(data[:, :half], psi0, scan[:, :half], prb0, g, *a,
                         **k)

        monkeypatch.setattr(solvers, name, broken)


def _nudge(x):
    x = x.clone()
    x[..., x.shape[-2] // 2, x.shape[-1] // 3] += 0.1 * x.abs().max()
    return x


def altered_answer(monkeypatch):
    fused = PROGRAM.fused
    real_grad = fused.grad_fused

    def broken_grad(*a, **k):
        grad, f = real_grad(*a, **k)
        return _nudge(grad), f

    monkeypatch.setattr(fused, "grad_fused", broken_grad)
    solvers = PROGRAM.solvers
    for name in ("run", "reconstruct"):
        real = getattr(solvers, name)

        def broken(*a, _real=real, **k):
            psi, prb, rest = _real(*a, **k)
            return _nudge(psi), prb, rest

        monkeypatch.setattr(solvers, name, broken)


def altered_return(monkeypatch):
    solvers = PROGRAM.solvers
    for name in ("run", "reconstruct"):
        real = getattr(solvers, name)

        def broken(*a, _real=real, **k):
            psi, prb, rest = _real(*a, **k)
            return _nudge(psi), _nudge(prb), rest

        monkeypatch.setattr(solvers, name, broken)


@pytest.mark.parametrize("fault", [zero_gradients, half_the_positions,
                                   altered_answer])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = tiny.execute(name)
    assert result["correct"] is False, result["checks"]


# The numbers that judge the object and probe a run returns.
ANSWER = {"psi_err", "prb_err", "residual", "answer_residual"}


@pytest.mark.parametrize("name", [n for n in tiny.CELLS
                                  if ANSWER & set(tiny.cell(n).limits)])
def test_an_answer_altered_on_return_is_not_correct(name, monkeypatch):
    altered_return(monkeypatch)
    result = tiny.execute(name)
    assert result["correct"] is False, result["checks"]
