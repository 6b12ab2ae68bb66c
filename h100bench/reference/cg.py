"""Plain conjugate-gradient ptychography: the reference solver.

The algorithm the configurations state, written out in plain PyTorch over
:mod:`h100bench.reference.ptycho`: Dai-Yuan directions on the
illumination-preconditioned object gradient; a backtracking line search
(step ``gamma0 * 0.5^k``, ``k <= 16``, the first step that does not raise
the objective, else no move) warm-started from ``min(1, 4 * previous
accepted step)``; with ``recover_prb``, after each object step a Dai-Yuan
step on the probe at the updated object, its gradient divided by the
object power each probe pixel sees, with its own warm-started search; a
stop after two iterations in a row in which nothing moved. The residual of
an iteration is taken at its start: ``sqrt(max(F - F_perfect, 0) /
sum(data))``.

It imports nothing of the program under test and takes nothing the program
made: the inputs are the benchmark's own.
"""

from __future__ import annotations

import dataclasses

import torch

from h100bench.reference.ptycho import Ptycho, rdot, residual

STEP0 = 1.0
SHRINK = 0.5
MAX_HALVINGS = 16
GROWTH = 4.0
STALL = 2


@dataclasses.dataclass
class Solution:
    psi: torch.Tensor
    prb: torch.Tensor
    residual: list  # one a started iteration
    gamma: list
    gamma_prb: list

    @property
    def iters(self) -> int:
        return len(self.residual)


def _warm_start(gamma_prev: float) -> float:
    return min(STEP0, GROWTH * gamma_prev) if gamma_prev > 0 else STEP0


def _backtrack(f_of, f0: float, gamma0: float) -> float:
    gamma, k = gamma0, 0
    fg = f_of(gamma)
    while fg > f0 and k < MAX_HALVINGS:
        gamma *= SHRINK
        fg = f_of(gamma)
        k += 1
    return gamma if fg <= f0 else 0.0


def _dai_yuan(g, g_prev, d_prev):
    den = rdot(d_prev, g - g_prev)
    beta = rdot(g, g) / den if den != 0 else 0.0
    return -g + beta * d_prev


def operator(problem, precision: str) -> Ptycho:
    g = problem.geometry
    return Ptycho(problem.scan, g["nz"], g["n"], g["nprb"], g["ndet"],
                  precision)


def solve(problem, iters: int, precision: str = "fp64",
          target: float = 0.0) -> Solution:
    """``iters`` iterations (fewer on a stall, or once the residual at an
    iteration's start is at most ``target`` > 0) from the problem's start,
    in ``precision``."""
    op = operator(problem, precision)
    model, joint = problem.model, problem.recover_prb
    data = problem.data
    total, perfect = op.data_sums(data, model)
    psi, prb = op.store(problem.psi0), op.store(problem.prb0)
    d, g_prev = torch.zeros_like(psi), torch.zeros_like(psi)
    d_prb, gp_prev = torch.zeros_like(prb), torch.zeros_like(prb)
    gam_prev = gam_p_prev = 0.0
    illum = op.illumination(prb)
    out = Solution(psi, prb, [], [], [])
    while len(out.residual) < iters:
        res = out.residual
        if target > 0 and res and not res[-1] > target:
            break
        if len(res) >= STALL and all(
                a == 0 and b == 0 for a, b in zip(out.gamma[-STALL:],
                                                  out.gamma_prb[-STALL:])):
            break
        # Object step.
        f0, g_raw, _ = op.evaluate(psi, prb, data, model, want_psi=True)
        if joint:
            illum = op.illumination(prb)
        g = op.store(g_raw / illum)
        d = op.store(_dai_yuan(g, g_prev, d))
        gamma0 = _warm_start(gam_prev)
        gamma = _backtrack(lambda s: op.evaluate(op.store(psi + s * d), prb,
                                                 data, model)[0], f0, gamma0)
        if gamma != 0.0:
            psi = op.store(psi + gamma * d)
        g_prev = g
        gamma_p = 0.0
        if joint:
            fp, _, gp_raw = op.evaluate(psi, prb, data, model,
                                        want_prb=True)
            gp = op.store(gp_raw / op.seen(psi)[:, None])
            d_prb = op.store(_dai_yuan(gp, gp_prev, d_prb))
            gamma_p = _backtrack(
                lambda s: op.evaluate(psi, op.store(prb + s * d_prb), data,
                                      model)[0], fp, _warm_start(gam_p_prev))
            if gamma_p != 0.0:
                prb = op.store(prb + gamma_p * d_prb)
            gp_prev = gp
            gam_p_prev = gamma_p
        res.append(residual(f0, total, perfect))
        out.gamma.append(gamma)
        out.gamma_prb.append(gamma_p)
        gam_prev = gamma
    out.psi, out.prb = psi, prb
    return out


def residual_at(problem, psi: torch.Tensor, prb: torch.Tensor) -> float:
    """The relative residual of ``(psi, prb)`` in complex128."""
    op = operator(problem, "fp64")
    total, perfect = op.data_sums(problem.data, problem.model)
    f, _, _ = op.evaluate(op.store(psi), op.store(prb), problem.data,
                          problem.model)
    return residual(f, total, perfect)
