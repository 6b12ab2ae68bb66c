"""The reference solver of :mod:`h100bench.reference.cg`, with a rejected
step's restart made exact.

When an iteration moves nothing (its line searches all return 0), the next
one starts from the same object and probe, so its objective and gradients
are those already computed, and Dai-Yuan's denominator ``<d, g - g_prev>``
is exactly 0: the direction restarts at ``-g``. ``cg`` evaluates them
again instead, and on a CUDA device ``index_add_`` sums a position's
patches with atomics in no fixed order, so the second gradient differs
from the first in its last bits: the denominator is then ~1e-14 instead
of 0, beta ~1e17, and no step of the search is small enough, so the solve
stops on the stall rule where the algorithm would have restarted. Here the
evaluations of an unmoved iterate are kept and reused: the algorithm, its
line search, its preconditioners and its stall rule are ``cg``'s.

It imports nothing of the program under test and takes nothing the program
made: the inputs are the benchmark's own.
"""

from __future__ import annotations

import torch

from h100bench.reference.cg import (STALL, Solution, _backtrack, _dai_yuan,
                                    _warm_start, operator, residual_at)
from h100bench.reference.ptycho import residual

__all__ = ["Solution", "residual_at", "solve"]


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
    # The evaluations at the current (psi, prb), dropped when either moves.
    at_obj = at_prb = None
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
        if at_obj is None:
            at_obj = op.evaluate(psi, prb, data, model, want_psi=True)[:2]
        f0, g_raw = at_obj
        if joint:
            illum = op.illumination(prb)
        g = op.store(g_raw / illum)
        d = op.store(_dai_yuan(g, g_prev, d))
        gamma0 = _warm_start(gam_prev)
        gamma = _backtrack(lambda s: op.evaluate(op.store(psi + s * d), prb,
                                                 data, model)[0], f0, gamma0)
        if gamma != 0.0:
            psi = op.store(psi + gamma * d)
            at_obj = at_prb = None
        g_prev = g
        gamma_p = 0.0
        if joint:
            if at_prb is None:
                fp, _, gp_raw = op.evaluate(psi, prb, data, model,
                                            want_prb=True)
                at_prb = fp, gp_raw
            fp, gp_raw = at_prb
            gp = op.store(gp_raw / op.seen(psi)[:, None])
            d_prb = op.store(_dai_yuan(gp, gp_prev, d_prb))
            gamma_p = _backtrack(
                lambda s: op.evaluate(psi, op.store(prb + s * d_prb), data,
                                      model)[0], fp, _warm_start(gam_p_prev))
            if gamma_p != 0.0:
                prb = op.store(prb + gamma_p * d_prb)
                at_obj = at_prb = None
            gp_prev = gp
            gam_p_prev = gamma_p
        res.append(residual(f0, total, perfect))
        out.gamma.append(gamma)
        out.gamma_prb.append(gamma_p)
        gam_prev = gamma
    out.psi, out.prb = psi, prb
    return out
