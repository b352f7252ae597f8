"""BiCGStab (bcgs).

Counterpart of ``petsc_tpu/ksp/bcgs.py`` (src/ksp/ksp/impls/bcgs/bcgs.c
KSPSolve_BCGS): the solver runs on the left-preconditioned system, r =
B(b - Ax), each step applies B A twice, and the default PRECONDITIONED
norm is ||r|| of that residual. Breakdowns ((v, rp) = 0; t = 0 with
s != 0) give KSP_DIVERGED_BREAKDOWN and leave x and r as they were; the
t = 0, s = 0 corner converges with x += alpha p. The step's scalars stay
on the card as 0-d tensors; the host reads the four that decide the
step, once per iteration.
"""

from __future__ import annotations

import torch

from ..ops.reduce import fdot, fnorm2
from ..sys.error import KSPConvergedReason as KR
from .common import (KSPConfig, NONE, SolveResult, UNPRECONDITIONED, check_converged,
                     empty_history, finalize_reason, rounder, tolerances)


def _nz(v):
    return torch.where(v == 0, torch.ones_like(v), v)


def solve_bcgs(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    dt = b.dtype
    rnd = rounder(dt)
    x = x0
    r0_un = b - A.mult(x) if cfg.guess_nonzero else b
    r = B.mult(r0_un)
    # the unpreconditioned norm tracks ||b - A x||
    dp0 = rnd(float(fnorm2(r0_un if cfg.normtype == UNPRECONDITIONED else r)))
    hist = empty_history(cfg, dt)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)

    rp = r
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    one = torch.ones((), dtype=dt, device=b.device)
    rhoold, alpha, omegaold = one, one, one
    its, rnorm, reason = 0, dp0, 0
    while reason == 0 and its < cfg.max_it:
        rho = fdot(r, rp)
        beta = (rho / _nz(rhoold)) * (alpha / _nz(omegaold))
        p = r - omegaold * beta * v + beta * p
        v = B.mult(A.mult(p))
        d1 = fdot(v, rp)
        alpha = rho / _nz(d1)
        sv = r - alpha * v
        t = B.mult(A.mult(sv))
        st, tt, ss = fdot(sv, t), fdot(t, t), fdot(sv, sv)
        omega = st / _nz(tt)
        x_new = x + alpha * p + omega * sv
        r_new = sv - omega * t
        dpt = fnorm2(r_new) if cfg.normtype != UNPRECONDITIONED else fnorm2(b - A.mult(x_new))
        d1_h, tt_h, ss_h, dp_h = torch.stack([d1, tt, ss, dpt]).tolist()
        its += 1
        brk = int(KR.DIVERGED_BREAKDOWN) if d1_h == 0 else 0
        # the t == 0 corner (bcgs.c:92-113)
        t_zero = tt_h == 0 and brk == 0
        if t_zero and ss_h != 0:
            brk = int(KR.DIVERGED_BREAKDOWN)
        if brk:
            reason = brk
        elif t_zero:
            reason, rnorm = int(KR.CONVERGED_RTOL), 0.0
            x = x + alpha * p
            hist[its] = 0.0
        else:
            dp = rnd(dp_h)
            reason = check_converged(dp, ttol, atol, dtol_bound) if cfg.normtype != NONE else 0
            x, r, rnorm = x_new, r_new, dp
            hist[its] = dp
        rhoold, omegaold = rho, omega
    reason = finalize_reason(reason, its, cfg)
    return SolveResult(x, its, rnorm, reason, hist, dp0)
