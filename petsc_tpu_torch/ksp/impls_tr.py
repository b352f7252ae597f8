"""Trust-region CG (stcg, which also serves nash and qcg), BiCGStab(ell)
and left conjugate directions.

Counterpart of ``petsc_tpu/ksp/impls_tr.py`` (references
src/ksp/ksp/impls/cg/stcg/stcg.c, cg/nash/nash.c, qcg/qcg.c,
bcgsl/bcgsl.c, lcd/lcd.c). Python loops with one host read of the
iteration's scalars; the small dense work of bcgsl (its ell x ell
least-squares step) and the products with a stored block of vectors
(lcd) run on ``torch.mv`` / ``torch.mm`` as GMRES's basis products do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sys.error import KSPConvergedReason as KR
from .common import (KSPConfig, axpy, dot, dp_of, host, initial_residual, norm, nz, scalar)
from .impls_more import _Loop


def small_solve(G, rhs, shift=1e-300):
    """g of (G + shift I) g = rhs for a small dense G, solved on the host
    in G's dtype (the reference's jnp.linalg.solve); g on G's device."""
    Gh = G.cpu().numpy()
    Gh = Gh + Gh.dtype.type(shift) * np.eye(rhs.numel(), dtype=Gh.dtype)
    g = np.linalg.solve(Gh, rhs.cpu().numpy())
    return torch.as_tensor(g, dtype=G.dtype, device=G.device)


def _extra(cfg: KSPConfig, key, default):
    for k, v in cfg.extra:
        if k == key:
            return v
    return default


def solve_stcg(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Steihaug-Toint truncated preconditioned CG (stcg.c): CG on the
    quadratic model from x = 0, stopping on the trust-region boundary
    ||x||_M = Delta (M the preconditioner's norm) or at negative curvature,
    where the step goes exactly to the boundary (CONVERGED_STEP_LENGTH). A
    radius of 0 (the default) is plain CG."""
    radius = float(_extra(cfg, "radius", 0.0))
    big = radius <= 0.0
    Delta = scalar(radius if radius > 0 else 1e300, b)
    r0 = initial_residual(A, b, x0, cfg)
    x = torch.zeros_like(b)
    r = r0
    z = B.mult(r)
    p = z
    rz = dot(r, z)
    lp = _Loop(cfg, b, float(dp_of(cfg.normtype, r0, z)), rtol, abstol, divtol)
    xMx = xMp = torch.zeros_like(rz)
    pMp = rz
    while lp.live():
        Ap = A.mult(p)
        kappa = dot(p, Ap)
        alpha_cg = rz / nz(kappa)
        xMx_new = xMx + 2 * alpha_cg * xMp + alpha_cg ** 2 * pMp
        hit = torch.zeros((), dtype=torch.bool, device=b.device) if big else \
            (kappa <= 0) | (xMx_new > Delta * Delta)
        disc = torch.clamp(xMp * xMp + pMp * (Delta * Delta - xMx), min=0.0)
        tau = (-xMp + torch.sqrt(disc)) / nz(pMp)
        alpha = torch.where(hit, tau, alpha_cg)
        x = axpy(x, alpha, p)
        r = axpy(r, -alpha, Ap)
        z = B.mult(r)
        rz_ = dot(r, z)
        beta = rz_ / nz(rz)
        p = axpy(z, beta, p)
        xMx = xMx + 2 * alpha * xMp + alpha ** 2 * pMp
        xMp = beta * (xMp + alpha * pMp)
        pMp = rz_ + beta * beta * pMp
        dp, hit_h = host(dp_of(cfg.normtype, r, z), hit.to(b.dtype))
        lp.step(dp, KR.CONVERGED_STEP_LENGTH if hit_h else 0)
        rz = rz_
    return lp.result(x)


def solve_bcgsl(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """BiCGstab(ell) (bcgsl.c, Sleijpen-Fokkema): ell BiCG sweeps, then a
    degree-ell minimum-residual polynomial step. ell from -ksp_bcgsl_ell
    (default 2); 2 ell products with B A per iteration."""
    ell = int(_extra(cfg, "ell", 2))
    x = x0
    n = b.numel()
    r_first = B.mult(initial_residual(A, b, x0, cfg))
    rt = r_first
    lp = _Loop(cfg, b, float(norm(r_first)), rtol, abstol, divtol)
    R = torch.zeros((ell + 1, n), dtype=b.dtype, device=b.device)
    U = torch.zeros((ell + 1, n), dtype=b.dtype, device=b.device)
    R[0] = r_first
    rho0, alpha, omega = scalar(1.0, b), scalar(0.0, b), scalar(1.0, b)
    one, neg_one = scalar(1.0, b), scalar(-1.0, b)

    def K(v):
        return B.mult(A.mult(v))

    while lp.live():
        rho0 = -omega * rho0
        for j in range(ell):
            rho1 = dot(rt, R[j])
            beta = alpha * rho1 / nz(rho0)
            rho0 = rho1
            for i in range(j + 1):
                U[i] = axpy(R[i], -beta, U[i])
            U[j + 1] = K(U[j])
            gamma = dot(rt, U[j + 1])
            alpha = rho0 / nz(gamma)
            for i in range(j + 1):
                R[i] = axpy(R[i], -alpha, U[i + 1])
            R[j + 1] = K(R[j])
            x = axpy(x, alpha, U[0])
        Z = R[1:]
        g = small_solve(torch.mm(Z, Z.t()), torch.mv(Z, R[0]))
        omega = g[ell - 1]
        x = axpy(x, one, torch.mv(R[:ell].t(), g))
        R0 = axpy(R[0], neg_one, torch.mv(Z.t(), g))
        U0 = axpy(U[0], neg_one, torch.mv(U[1:].t(), g))
        R[0], U[0] = R0, U0
        dp, om_h = host(norm(R0), omega)
        lp.step(dp, KR.DIVERGED_BREAKDOWN if abs(om_h) == 0 else 0)
    return lp.result(x)


def solve_lcd(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Left conjugate directions (lcd.c, Yuan/Golub/Dai): restart cycles of
    k steps, each new direction p = r biorthogonalized against the cycle's
    stored directions through their cached images q = B A p (one product
    with B A per step). As the reference's, the iteration count is tested
    against max_it only between cycles, and the history holds the initial
    and the final norm."""
    k = int(_extra(cfg, "restart", 30))
    x = x0
    n = b.numel()
    r = B.mult(initial_residual(A, b, x0, cfg))
    lp = _Loop(cfg, b, float(norm(r)), rtol, abstol, divtol)
    p0 = r
    neg_one = scalar(-1.0, b)
    while lp.live():
        P = torch.zeros((k + 1, n), dtype=b.dtype, device=b.device)
        Q = torch.zeros((k + 1, n), dtype=b.dtype, device=b.device)
        pq = torch.ones(k + 1, dtype=b.dtype, device=b.device)
        P[0] = p0
        Q[0] = B.mult(A.mult(p0))
        pq[0] = dot(P[0], Q[0])
        for it in range(k):
            if lp.reason != 0:
                break
            alfa = dot(P[it], r) / nz(pq[it])
            x = axpy(x, alfa, P[it])
            r = axpy(r, -alfa, Q[it])
            lp.step(float(norm(r)), record=False)
            pn = r
            qn = B.mult(A.mult(pn))
            coeffs = torch.mv(P[:it + 1], qn) / nz(pq[:it + 1])
            pn = axpy(pn, neg_one, torch.mv(P[:it + 1].t(), coeffs))
            qn = axpy(qn, neg_one, torch.mv(Q[:it + 1].t(), coeffs))
            P[it + 1], Q[it + 1] = pn, qn
            pq[it + 1] = dot(pn, qn)
        p0 = r
    lp.hist[min(lp.its, cfg.max_it)] = lp.rnorm
    return lp.result(x)
