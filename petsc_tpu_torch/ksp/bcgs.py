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
from ..sys.error import Error, KSPConvergedReason as KR
from .common import (KSPConfig, NONE, SolveResult, UNPRECONDITIONED, axpy, check_converged,
                     dot, empty_history, finalize_reason, host, initial_residual, norm, nz,
                     rounder, scalar, tolerances)


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


def solve_ibcgs(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """IBCGS (ibcgs.c, Yang & Brent 2002): BiCGStab restructured so that the
    six inner products of an iteration (phi, pi, gamma, eta, theta, kappa)
    come from one set of vectors. It needs f0 = (B A)^T r0 once, so both A
    and the PC must have a transpose (an Error otherwise, as the
    reference's: a forward product in its place corrupts the recurrence).
    Two products with B A per iteration (q = B A v, u = B A r)."""
    if getattr(A, "mult_t", None) is None or getattr(B, "mult_t", None) is None:
        raise Error("KSP ibcgs needs MatMultTranspose and PCApplyTranspose (ibcgs.c); this "
                    "operator/PC pair provides no transpose apply: use bcgs, or a "
                    "transpose-capable PC (e.g. -pc_factor_transpose_solve for ilu/lu)")
    rnd = rounder(b.dtype)
    x = x0
    r0 = B.mult(initial_residual(A, b, x, cfg))
    dp0 = rnd(float(norm(r0)))
    hist = empty_history(cfg, b.dtype)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)
    u = B.mult(A.mult(r0))
    f0 = A.mult_t(B.mult_t(r0))
    zero = torch.zeros_like(b)
    z, v, q, r = zero, zero, zero, r0
    one = scalar(1.0, b)
    zs = torch.zeros_like(one)
    sig2, sig1, pi1, phi1, tau1, alpha1, omega1 = zs, dot(r0, u), zs, dot(r0, r0), zs, one, one
    its, rnorm, reason = 0, dp0, 0
    while reason == 0 and its < cfg.max_it:
        rho = phi1 - omega1 * sig2 + omega1 * alpha1 * pi1
        delta = rho if its == 0 else rho / nz(tau1)
        beta = delta / nz(omega1)
        tau = sig1 + beta * tau1 - delta * pi1
        alpha = rho / nz(tau)
        zn = axpy(axpy(alpha * r, (alpha / nz(alpha1)) * beta, z), -(alpha * delta), v)
        vn = axpy(axpy(u, beta, v), -delta, q)
        sn = axpy(r, -alpha, vn)
        qn = B.mult(A.mult(vn))
        tn = axpy(u, -alpha, qn)
        phi, pi_, gamma = dot(r0, sn), dot(r0, qn), dot(f0, sn)
        eta, theta, kappa = dot(f0, tn), dot(sn, tn), dot(tn, tn)
        omega = theta / nz(kappa)
        sigma = gamma - omega * eta
        rn = axpy(sn, -omega, tn)
        xn = axpy(axpy(x, one, zn), omega, sn)
        dp_h, tau_h, kappa_h, theta_h = host(norm(rn), tau, kappa, theta)
        its += 1
        brk = int(KR.DIVERGED_BREAKDOWN) if (tau_h == 0 or kappa_h == 0 or theta_h == 0) else 0
        un = B.mult(A.mult(rn))
        if brk:
            reason = brk
        else:
            dp = rnd(dp_h)
            reason = check_converged(dp, ttol, atol, dtol_bound) if cfg.normtype != NONE else 0
            x, r, rnorm = xn, rn, dp
            hist[its] = dp
        u, z, v, q = un, zn, vn, qn
        sig2, sig1, pi1, phi1, tau1, alpha1, omega1 = sig1, sigma, pi_, phi, tau, alpha, omega
    reason = finalize_reason(reason, its, cfg)
    return SolveResult(x, its, rnorm, reason, hist, dp0)
