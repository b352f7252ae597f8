"""KSP implementations: preonly, richardson, cg, minres.

Counterpart of ``petsc_tpu/ksp/impls_basic.py``. Semantics follow the
reference implementations:
  preonly    src/ksp/ksp/impls/preonly/preonly.c
  richardson src/ksp/ksp/impls/rich/rich.c
  cg         src/ksp/ksp/impls/cg/cg.c:119 (KSPSolve_CG)
  minres     src/ksp/ksp/impls/minres/minres.c
The JAX ``lax.while_loop`` becomes a Python loop with one host read of
the iteration's scalars; on the card, the CG body runs on the kernels of
``ops.pallas_kernels``.
"""

from __future__ import annotations

import math

import torch

from ..ops.pallas_kernels import axpy_normsq, dot2, triad
from ..ops.reduce import fdot, fnorm2
from ..sys.error import KSPConvergedReason as KR
from .common import (KSPConfig, NATURAL, NONE, PRECONDITIONED,
                     SolveResult, UNPRECONDITIONED, check_converged,
                     empty_history, finalize_reason, initial_residual, rounder,
                     tolerances)


def solve_preonly(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """x = B b: apply the preconditioner exactly once (preonly.c)."""
    rhs = b if not cfg.guess_nonzero else initial_residual(A, b, x0, cfg)
    x = B.mult(rhs)
    if x is rhs:
        x = x.clone()        # an identity PC must not hand back b itself
    if cfg.guess_nonzero:
        x = x0 + x
    return SolveResult(x, 1, 0.0, int(KR.CONVERGED_ITS), empty_history(cfg, b.dtype), 0.0)


def _dp(normtype, r, z) -> float:
    """The norm that the norm type selects, as a host float."""
    if normtype == PRECONDITIONED:
        return float(fnorm2(z))
    if normtype == UNPRECONDITIONED:
        return float(fnorm2(r))
    if normtype == NATURAL:
        return math.sqrt(abs(float(fdot(z, r))))
    return 0.0


def _dp_host(normtype, rz, sq) -> float:
    """_dp from host scalars: rz = <r, z>, sq = the norm type's squared norm."""
    if normtype in (PRECONDITIONED, UNPRECONDITIONED):
        return math.sqrt(sq)
    if normtype == NATURAL:
        return math.sqrt(abs(rz))
    return 0.0


def solve_richardson(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """x <- x + scale * B(b - A x) (rich.c). cfg.extra = (scale,)."""
    scale = cfg.extra[0] if cfg.extra else 1.0
    r = initial_residual(A, b, x0, cfg)
    x = x0           # updated in place (the reference donates x0's buffer)
    z = B.mult(r)
    rnd = rounder(b.dtype)
    dp0 = rnd(_dp(cfg.normtype, r, z))
    hist = empty_history(cfg, b.dtype)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)
    its, rnorm, reason = 0, dp0, 0
    while reason == 0 and its < cfg.max_it:
        x.add_(z, alpha=scale)
        r = b - A.mult(x)
        z = B.mult(r)
        dp = rnd(_dp(cfg.normtype, r, z))
        its += 1
        hist[its] = dp
        rnorm = dp
        reason = check_converged(dp, ttol, atol, dtol_bound) \
            if cfg.normtype != NONE else 0
    reason = finalize_reason(reason, its, cfg)
    return SolveResult(x, its, rnorm, reason, hist, dp0)


def solve_cg(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Preconditioned conjugate gradients, PETSc ordering (cg.c:119):
    breakdown/indefiniteness checks on beta and p'Ap, convergence tested on
    the preconditioned norm by default, iteration-0 norm monitored but not
    tested (chknorm).

    x0 is the initial iterate (KSP.solve passes fresh zeros for a zero
    guess) and is updated in place, as the reference donates its buffer
    to the loop state; r, p and x are the only vectors carried across
    iterations, and z = B r lives within one iteration. Per iteration the
    host reads one stacked triple (<p, Ap>, <r, z>, squared norm); the
    step lengths stay on the card as 0-d tensors that the kernels read."""
    nt = cfg.normtype
    r = initial_residual(A, b, x0, cfg)
    if r is b:
        r = b.clone()            # r is updated in place; b stays the caller's
    x = x0

    z = B.mult(r)
    # one dot2 gives beta0 = <r0, z0> and the squared norm of the norm type
    if nt == UNPRECONDITIONED:
        rz, sq = dot2(z, r)
    else:
        rz, sq = dot2(r, z)
    beta, sq0 = torch.stack([rz, sq]).tolist()
    rnd = rounder(b.dtype)
    dp0 = rnd(_dp_host(nt, beta, sq0))
    hist = empty_history(cfg, b.dtype)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)
    p = z.clone()                # p0 = z0; z may be r itself (PC none)

    betaold, its, rnorm, reason = 1.0, 0, dp0, 0
    while reason == 0 and its < cfg.max_it:
        # breakdown checks (before any update, like the reference); the
        # reference's step is then an identity on x and r
        if beta == 0:
            reason, its = int(KR.CONVERGED_ATOL), its + 1
            break
        if its > 0 and beta * betaold < 0:
            reason, its = int(KR.DIVERGED_INDEFINITE_PC), its + 1
            break
        w = A.mult(p)
        dpi, _ = dot2(w, p)
        # a = beta / <p, Ap>, or 0 when <p, Ap> <= 0 (DIVERGED_INDEFINITE_MAT:
        # x and r then stay as they are)
        a = torch.where(dpi <= 0, 0.0, beta / dpi)
        triad(x, p, a, out=x)
        _, rr = axpy_normsq(-a, w, r, out=r)
        z = B.mult(r)
        rz, zz = dot2(r, z)
        # p's value after a breakdown is never read
        triad(z, p, rz / beta, out=p)
        dpi_h, rz_h, sq_h = torch.stack(
            [dpi, rz, rr if nt == UNPRECONDITIONED else zz]).tolist()
        its += 1                 # PETSc sets its = i + 1 either way
        if dpi_h <= 0:
            reason = int(KR.DIVERGED_INDEFINITE_MAT)
            break
        dp = rnd(_dp_host(nt, rz_h, sq_h))
        reason = check_converged(dp, ttol, atol, dtol_bound) \
            if nt != NONE else 0
        hist[its] = dp
        rnorm = dp
        beta, betaold = rz_h, beta
    reason = finalize_reason(reason, its, cfg)
    return SolveResult(x, its, rnorm, reason, hist, dp0, r)


def solve_minres(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """MINRES for symmetric (indefinite) systems with an SPD preconditioner
    (minres.c), the reference's recurrence: the natural norm drives the
    Lanczos step, the monitored norm is the norm type's, and |eta| is
    tested. The recurrence's scalars stay on the card as 0-d tensors; the
    host reads |eta| once per iteration."""
    r0 = initial_residual(A, b, x0, cfg)
    x = x0
    z0 = B.mult(r0)
    dp0 = torch.sqrt(torch.abs(fdot(z0, r0)))   # the natural norm drives MINRES
    rnd = rounder(b.dtype)
    mon0 = rnd(_dp(cfg.normtype, r0, z0))
    hist = empty_history(cfg, b.dtype)
    hist[0] = mon0
    ttol, atol, dtol_bound = tolerances(mon0, rtol, abstol, divtol, rnd)

    one, zero = torch.ones_like(dp0), torch.zeros_like(dp0)
    v_old, v, z = torch.zeros_like(b), r0, z0
    w, w_old = torch.zeros_like(b), torch.zeros_like(b)
    beta, beta_old, c, c_old, s, s_old, eta = dp0, one, one, one, zero, zero, dp0
    its, rnorm, reason = 0, mon0, 0
    while reason == 0 and its < cfg.max_it:
        v_hat = z / beta
        Av = A.mult(v_hat)
        alpha = fdot(v_hat, Av)
        v_new = Av - (alpha / beta) * v - (beta / beta_old) * v_old
        z_new = B.mult(v_new)
        beta_new = torch.sqrt(torch.abs(fdot(z_new, v_new)))
        # the Givens rotation
        d0 = c * alpha - c_old * s * beta
        d1 = torch.sqrt(d0 * d0 + beta_new * beta_new)
        d2 = s * alpha + c_old * c * beta
        d3 = s_old * beta
        c_new = d0 / d1
        s_new = beta_new / d1
        w_new = (v_hat - d3 * w_old - d2 * w) / d1
        x = x + c_new * eta * w_new
        eta = -s_new * eta
        its += 1
        dp = rnd(abs(float(eta)))
        hist[its] = dp
        rnorm = dp
        reason = check_converged(dp, ttol, atol, dtol_bound)
        v_old, v, z = v, v_new, z_new
        beta_old, beta = beta, beta_new
        c_old, c, s_old, s = c, c_new, s, s_new
        w_old, w = w, w_new
    reason = finalize_reason(reason, its, cfg)
    return SolveResult(x, its, rnorm, reason, hist, mon0)
