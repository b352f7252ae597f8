"""KSP implementations bicg, cgls and qmrcgs.

Counterpart of ``petsc_tpu/ksp/impls_r3.py``:
  bicg    src/ksp/ksp/impls/bicg/bicg.c (KSPSolve_BiCG): biconjugate
          gradients; the shadow recurrence applies A^T and B^T;
  cgls    src/ksp/ksp/impls/cg/cgls/cgls.c: CG on A^T A x = A^T b, the PC
          not applied, ||b - A x|| monitored;
  qmrcgs  src/ksp/ksp/impls/bcgs/qmrcgs/qmrcgs.c: QMRCGSTAB, BiCGStab with
          two quasi-minimization half-steps per iteration.

BiCG's B^T is the preconditioner's own transpose: where the PC has none
the solve raises, where the reference applies B in its place
(impls_r3.py:38, which on the non-symmetric config-2 stencil with ILU
runs to DIVERGED_ITS). The operator keeps the reference's fallback: A's
product where A has no transpose (A is then taken as symmetric).
"""

from __future__ import annotations

import torch

from ..sys.error import Error, KSPConvergedReason as KR
from .common import (KSPConfig, PRECONDITIONED, axpy, dot, host, initial_residual, norm,
                     nz, scalar)
from .impls_more import _Loop, _transpose_op


def pc_transpose(B, ksp_type):
    """The preconditioner's transpose product, or an Error that names the
    option giving the factorization PCs one."""
    if getattr(B, "mult_t", None) is None:
        raise Error(f"KSP {ksp_type} needs the preconditioner's transpose (PCApplyTranspose); "
                    "this PC has none: use -pc_factor_transpose_solve with ilu, icc, lu or "
                    "cholesky, or a PC with a transpose (none, jacobi)")
    return B.mult_t


def solve_bicg(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """BiCG (bicg.c) on the left-preconditioned system, the shadow residual
    seeded with r0; for a symmetric A and B it reproduces CG at twice the
    products."""
    At = _transpose_op(A)
    Bt = pc_transpose(B, "bicg")
    x = x0
    r = initial_residual(A, b, x0, cfg)
    z = B.mult(r)
    rt = r
    zt = Bt(rt)
    lp = _Loop(cfg, b, float(norm(z) if cfg.normtype == PRECONDITIONED else norm(r)),
               rtol, abstol, divtol)
    p, pt, beta = z, zt, dot(z, rt)
    while lp.live():
        w = A.mult(p)
        wt = At(pt)
        dpi = dot(pt, w)
        a = beta / nz(dpi)
        x = axpy(x, a, p)
        r = axpy(r, -a, w)
        rt = axpy(rt, -a, wt)
        z = B.mult(r)
        zt = Bt(rt)
        beta_new = dot(z, rt)
        bc = beta_new / nz(beta)
        p = axpy(z, bc, p)
        pt = axpy(zt, bc, pt)
        dp, dpi_h, beta_h = host(norm(z) if cfg.normtype == PRECONDITIONED else norm(r),
                            dpi, beta_new)
        brk = KR.DIVERGED_BREAKDOWN if dpi_h == 0 else (KR.CONVERGED_ATOL if beta_h == 0
                                                        else 0)
        lp.step(dp, brk)
        beta = beta_new
    return lp.result(x)


def solve_cgls(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """CGLS (cgls.c) in the Paige-Saunders form; the PC is not applied and
    the norm is ||r|| = ||b - A x||."""
    At = _transpose_op(A)
    x = x0
    r = initial_residual(A, b, x, cfg)
    s = At(r)
    gamma = dot(s, s)
    lp = _Loop(cfg, b, float(norm(r)), rtol, abstol, divtol)
    p = s
    while lp.live():
        q = A.mult(p)
        qq = dot(q, q)
        a = gamma / nz(qq)
        x = axpy(x, a, p)
        r = axpy(r, -a, q)
        s = At(r)
        gamma_new = dot(s, s)
        p = axpy(s, gamma_new / nz(gamma), p)
        dp, qq_h = host(norm(r), qq)
        lp.step(dp, KR.DIVERGED_BREAKDOWN if qq_h == 0 else 0)
        gamma = gamma_new
    return lp.result(x)


def solve_qmrcgs(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """QMRCGSTAB (qmrcgs.c): the BiCGStab recurrence of B A with two
    quasi-minimization half-steps (tau, theta, eta of Chan et al. 1994);
    the norm is the quasi-minimal tau."""
    x = x0
    r = B.mult(initial_residual(A, b, x, cfg))
    tau = norm(r)
    lp = _Loop(cfg, b, float(tau), rtol, abstol, divtol)
    rt = r
    zero = torch.zeros_like(b)
    p, v, d = zero, zero, zero
    one = scalar(1.0, b)
    rho_old, alpha, omega = one, one, one
    theta, eta = torch.zeros_like(one), torch.zeros_like(one)
    while lp.live():
        rho = dot(rt, r)
        beta = (rho / nz(rho_old)) * (alpha / nz(omega))
        p = axpy(r, beta, axpy(p, -omega, v))
        v = B.mult(A.mult(p))
        d1 = dot(rt, v)
        alpha = rho / nz(d1)
        sv = axpy(r, -alpha, v)
        th1 = norm(sv) / nz(tau)
        c1 = 1.0 / torch.sqrt(1.0 + th1 * th1)
        tau1 = tau * th1 * c1
        eta1 = c1 * c1 * alpha
        d1v = axpy(p, theta * theta * eta / nz(alpha), d)
        x1 = axpy(x, eta1, d1v)
        t = B.mult(A.mult(sv))
        tt = dot(t, t)
        omega = dot(t, sv) / nz(tt)
        r = axpy(sv, -omega, t)
        th2 = norm(r) / nz(tau1)
        c2 = 1.0 / torch.sqrt(1.0 + th2 * th2)
        tau = tau1 * th2 * c2
        eta2 = c2 * c2 * omega
        d = axpy(sv, th1 * th1 * eta1 / nz(omega), d1v)
        x = axpy(x1, eta2, d)
        dp, rho_h, d1_h, tt_h = host(tau, rho, d1, tt)
        brk = KR.DIVERGED_BREAKDOWN if (rho_h == 0 or d1_h == 0 or tt_h == 0) else 0
        lp.step(dp, brk)
        rho_old, theta, eta = rho, th2, eta2
    return lp.result(x)
