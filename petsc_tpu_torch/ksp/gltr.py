"""GLTR: the Gould-Lucidi-Roma-Toint generalized Lanczos trust region.

Counterpart of ``petsc_tpu/ksp/gltr.py`` (reference
src/ksp/ksp/impls/cg/gltr/gltr.c): preconditioned CG that records the
Lanczos tridiagonal T from its coefficients. Inside the trust region
||x||_M <= Delta it is STCG; once the boundary is hit (or the curvature is
negative) the Lanczos recurrence goes on for up to 20 more steps and the
solve ends by minimizing the model over the Krylov space on the boundary,

    min_h  1/2 h^T T h - ||r0||_M e1^T h   s.t. ||h|| <= Delta,

by a safeguarded More-Sorensen Newton iteration on lambda with LDL^T
sweeps of the tridiagonal, the smallest eigenvalue of T by Sturm-count
bisection, and the hard case by an eigenvector step. x = Q h is then
rebuilt by replaying the CG recurrence. The CG phase and the replay run
on the device (one host read per iteration); the tridiagonal work, at
most 160 entries, runs on the host in float64, over the t active entries
(the reference's masked sweeps over its fixed 160 give the same values).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..sys.error import KSPConvergedReason as KR
from .common import KSPConfig, axpy, dot, dp_of, host, initial_residual, nz, scalar
from .impls_more import _Loop

LANCZOS_EXTRA = 20           # gltr.c's max_lanczos_its default


def _nzf(v):
    return 1.0 if v == 0 else v


def _ldl_sweep(d, e, lam, t, rhs0):
    """LDL^T of (T + lam I), T = tridiag(e, d, e) over t entries: the pivots
    c, h solving (T + lam I) h = rhs0 e1, and the count of negative pivots."""
    c = np.ones(t)
    u = np.zeros(t)
    negct = 0
    for i in range(t):
        ei = e[i] if i > 0 else 0.0
        cim1 = c[i - 1] if i > 0 else 1.0
        c[i] = d[i] + lam - ei * ei / _nzf(cim1)
        u[i] = (rhs0 if i == 0 else 0.0) - (ei / _nzf(cim1)) * (u[i - 1] if i > 0 else 0.0)
        negct += c[i] < 0
    h = np.zeros(t)
    for i in range(t - 1, -1, -1):
        lip1 = e[i + 1] / _nzf(c[i]) if i + 1 < t else 0.0
        h[i] = u[i] / _nzf(c[i]) - lip1 * (h[i + 1] if i + 1 < t else 0.0)
    return c, h, negct


def _lambda_min(d, e, t, iters=60):
    """The smallest eigenvalue of T by Sturm-count bisection (stebz's role)."""
    abse = np.abs(e[:t])
    rad = abse + np.concatenate([abse[1:], [0.0]])
    lo, hi = float(np.min(d[:t] - rad)), float(np.max(d[:t] + rad))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if _ldl_sweep(d, e, -mid, t, 0.0)[2] >= 1:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def _fwd_wsq(c, e, h, t):
    """||Lhat^{-1} h||^2 for the Newton step (l_i = e_i / c_{i-1})."""
    u = np.zeros(t)
    wsq = 0.0
    for i in range(t):
        ui = h[i] - ((e[i] / _nzf(c[i - 1])) * u[i - 1] if i > 0 else 0.0)
        u[i] = ui
        wsq += ui * ui / _nzf(c[i])
    return wsq


def _solve_tridiag_tr(d, e, t, rnorm0, Delta):
    """More-Sorensen on the tridiagonal subproblem (gltr.py:133-187): h."""
    lmin = _lambda_min(d, e, t)
    lam_floor = max(0.0, -lmin) * (1 + 1e-10) + 1e-12
    h0 = _ldl_sweep(d, e, 0.0, t, rnorm0)[1]
    interior_ok = lmin > 0 and math.sqrt(h0 @ h0) <= Delta
    hi = lam_floor + rnorm0 / _nzf(Delta) + 1.0
    lo = lam_floor
    lam = lam_floor + 0.5 * (hi - lam_floor)
    for _ in range(60):
        c, h, _ = _ldl_sweep(d, e, lam, t, rnorm0)
        hn = math.sqrt(h @ h)
        wsq = _fwd_wsq(c, e, h, t)
        if hn > Delta:
            lo = lam
        else:
            hi = lam
        lam_n = lam + (hn * hn / _nzf(wsq)) * (hn - Delta) / _nzf(Delta)
        lam = lam_n if (lo < lam_n < hi and math.isfinite(lam_n)) else 0.5 * (lo + hi)
    h = _ldl_sweep(d, e, lam, t, rnorm0)[1]
    hn = math.sqrt(h @ h)
    at_floor = lam <= lam_floor * (1 + 1e-6) + 1e-12
    hard = hn < (1 - 1e-6) * Delta and at_floor and lmin <= 0
    if interior_ok:
        return h0
    if hard:
        v1 = _ldl_sweep(d, e, -(lmin - 1e-8 * max(abs(lmin), 1.0)), t, 1.0)[1]
        v = v1 / _nzf(math.sqrt(v1 @ v1))
        hv = h @ v
        tau = -hv + math.sqrt(max(hv * hv + (Delta * Delta - hn * hn), 0.0))
        h = h + tau * v
    return h


def solve_gltr(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    radius = 0.0
    for k, v in cfg.extra:
        if k == "radius":
            radius = float(v)
    big = radius <= 0.0
    Delta = radius if radius > 0 else 1e300
    TMAX = int(min(cfg.max_it + LANCZOS_EXTRA, 160))
    r0 = initial_residual(A, b, x0, cfg)
    z0 = B.mult(r0)
    rz0 = dot(r0, z0)
    lp = _Loop(cfg, b, float(dp_of(cfg.normtype, r0, z0)), rtol, abstol, divtol)
    rnorm0_M = math.sqrt(abs(float(rz0)))
    D2 = scalar(Delta, b) * scalar(Delta, b)
    x, r, z, p, rz = torch.zeros_like(b), r0, z0, z0, rz0
    xMx = xMp = torch.zeros_like(rz0)
    pMp = rz0
    alphas, betas = [], []
    boundary, lanczos_left, k = False, LANCZOS_EXTRA, 0
    while lp.reason == 0 and lp.its < cfg.max_it and k < TMAX:
        Ap = A.mult(p)
        kappa = dot(p, Ap)
        alpha = rz / nz(kappa)
        xMx_new = xMx + 2 * alpha * xMp + alpha ** 2 * pMp
        hit_now = (kappa <= 0) | (xMx_new > D2)
        r = axpy(r, -alpha, Ap)
        z = B.mult(r)
        rz2 = dot(r, z)
        beta = rz2 / nz(rz)
        dp_t = dp_of(cfg.normtype, r, z)
        hit_h, dp, rz2_h = host(hit_now.to(b.dtype), dp_t, rz2)
        boundary2 = boundary or (not big and bool(hit_h))
        if not boundary2:
            x = axpy(x, alpha, p)
            xMx, xMp = xMx_new, beta * (xMp + alpha * pMp)
        p = axpy(z, beta, p)
        pMp = rz2 + beta * beta * pMp
        alphas.append(alpha)
        betas.append(beta)
        if not boundary:
            lp.step(dp)
        if boundary2:
            lp.reason = 0
            lanczos_left -= 1
            if lanczos_left <= 0 or rz2_h == 0 or not math.isfinite(rz2_h):
                lp.reason = int(KR.CONVERGED_STEP_LENGTH)
        boundary, rz, k = boundary2, rz2, k + 1
    if boundary:
        a = np.asarray(host(*alphas)) if alphas else np.zeros(0)
        bb = np.asarray(host(*betas)) if betas else np.zeros(0)
        a_prev = np.concatenate([[1.0], a[:-1]])
        b_prev = np.concatenate([[0.0], bb[:-1]])
        a_nz = np.where(a == 0, 1.0, a)
        d = 1.0 / a_nz + b_prev / np.where(a_prev == 0, 1.0, a_prev)
        e = np.where(np.arange(k) > 0,
                     np.sqrt(np.abs(b_prev)) / np.where(a_prev == 0, 1.0, np.abs(a_prev)), 0.0)
        h = _solve_tridiag_tr(d, e, k, rnorm0_M, Delta)
        x = torch.zeros_like(b)
        r, z, p, rz = r0, z0, z0, rz0
        for i in range(k):
            q = z / nz(torch.sqrt(torch.abs(rz)))
            x = axpy(x, scalar((1.0 - 2.0 * (i % 2)) * h[i], b), q)
            r = axpy(r, -alphas[i], A.mult(p))
            z = B.mult(r)
            rz = dot(r, z)
            p = axpy(z, betas[i], p)
    if lp.reason == 0 and lp.its < cfg.max_it:
        # the Lanczos space is full (k == TMAX): the trust-region solution
        # over it, CONVERGED_ITS
        lp.reason = int(KR.CONVERGED_ITS)
    return lp.result(x)
