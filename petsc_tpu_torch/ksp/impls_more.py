"""More Krylov methods: cgs, tfqmr, cr, gcr, lsqr, symmlq, cgne, fcg and
pipecg (which also serves pipecg2, pipecgrr, pipelcg, pipeprcg, groppcg).

Counterpart of ``petsc_tpu/ksp/impls_more.py`` (references
src/ksp/ksp/impls/{cgs/cgs.c, tfqmr/tfqmr.c, cr/cr.c, gcr/gcr.c,
lsqr/lsqr.c, cg/pipecg/pipecg.c, cg/groppcg/groppcg.c, symmlq/symmlq.c,
cg/cgne/cgne.c, fcg/fcg.c}). Each JAX ``lax.while_loop`` becomes a Python
loop with one host read of the iteration's scalars; the step's scalars
stay on the device as 0-d tensors, updated as the reference updates its
loop state (a step that ends in a breakdown still updates x, as there).
The vector steps run on the hand kernels through :mod:`.common` (K4 for
the dots and norms, K2 for y + alpha x), the products with a stored block
of vectors (gcr, fcg) on ``torch.mv``, as GMRES's.
"""

from __future__ import annotations

import torch

from ..sys.error import KSPConvergedReason as KR
from .common import (KSPConfig, NONE, SolveResult, axpy, check_converged, dot, dp_of,
                     empty_history, finalize_reason, host, initial_residual, norm, nz,
                     rounder, scalar, tolerances)


class _Loop:
    """The bookkeeping shared by the loops: the history, the tolerances in
    the solve's dtype, and the convergence test of one iteration."""

    def __init__(self, cfg, b, dp0, rtol, abstol, divtol):
        self.cfg = cfg
        self.rnd = rounder(b.dtype)
        self.dp0 = self.rnd(dp0)
        self.hist = empty_history(cfg, b.dtype)
        self.hist[0] = self.dp0
        self.tol = tolerances(self.dp0, rtol, abstol, divtol, self.rnd)
        self.its, self.rnorm, self.reason = 0, self.dp0, 0

    def live(self):
        return self.reason == 0 and self.its < self.cfg.max_it

    def step(self, dp, breakdown=0, record=True):
        """One iteration ends with norm dp: its + 1, the history, the test;
        a nonzero `breakdown` reason takes the test's place."""
        dp = self.rnd(dp)
        self.its += 1
        if record:
            self.hist[min(self.its, self.cfg.max_it)] = dp
        self.rnorm = dp
        self.reason = check_converged(dp, *self.tol) if self.cfg.normtype != NONE else 0
        if breakdown:
            self.reason = int(breakdown)

    def result(self, x, rnorm0=None):
        return SolveResult(x, self.its, self.rnorm, finalize_reason(self.reason, self.its,
                                                                     self.cfg),
                           self.hist, self.dp0 if rnorm0 is None else rnorm0)


def solve_cgs(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Conjugate gradients squared (cgs.c), on B A with the shadow residual
    r0 = B(b - A x0)."""
    x = x0
    r = B.mult(initial_residual(A, b, x0, cfg))
    rt = r
    lp = _Loop(cfg, b, float(norm(r)), rtol, abstol, divtol)
    one = scalar(1.0, b)
    u, p, q, rho_old = r, r, torch.zeros_like(b), one
    while lp.live():
        rho = dot(rt, r)
        beta = rho / nz(rho_old)
        if lp.its == 0:
            u_, p_ = r, r
        else:
            u_ = axpy(r, beta, q)
            p_ = axpy(u_, beta, axpy(q, beta, p))
        v = B.mult(A.mult(p_))
        sig = dot(rt, v)
        alpha = rho / nz(sig)
        q_ = axpy(u_, -alpha, v)
        w = axpy(u_, one, q_)
        x = axpy(x, alpha, w)
        r = axpy(r, -alpha, B.mult(A.mult(w)))
        dp, sig_h, rho_h = host(norm(r), sig, rho)
        lp.step(dp, KR.DIVERGED_BREAKDOWN if sig_h == 0 or rho_h == 0 else 0)
        u, p, q, rho_old = u_, p_, q_, rho
    return lp.result(x)


def solve_tfqmr(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Transpose-free QMR (tfqmr.c, Freund's algorithm); the monitored norm
    is the QMR bound tau sqrt(2 (its + 1)). Three products with B A per
    iteration: B A y, B A y2 (both half-steps and the next v share it) and
    B A y_next."""
    x = x0
    r = B.mult(initial_residual(A, b, x0, cfg))
    dp0 = norm(r)
    lp = _Loop(cfg, b, float(dp0), rtol, abstol, divtol)
    rt, w, y = r, r, r
    v = B.mult(A.mult(y))
    d = torch.zeros_like(b)
    tau, theta, eta = dp0, torch.zeros_like(dp0), torch.zeros_like(dp0)
    rho = dot(rt, r)
    while lp.live():
        sigma = dot(rt, v)
        alpha = rho / nz(sigma)
        y2 = axpy(y, -alpha, v)
        w1 = axpy(w, -alpha, B.mult(A.mult(y)))
        theta1 = norm(w1) / nz(tau)
        c1 = 1.0 / torch.sqrt(1.0 + theta1 ** 2)
        tau1 = tau * theta1 * c1
        eta1 = c1 ** 2 * alpha
        d1 = axpy(y, theta ** 2 * eta / nz(alpha), d)
        x1 = axpy(x, eta1, d1)
        Ky2 = B.mult(A.mult(y2))
        w2 = axpy(w1, -alpha, Ky2)
        theta2 = norm(w2) / nz(tau1)
        c2 = 1.0 / torch.sqrt(1.0 + theta2 ** 2)
        tau2 = tau1 * theta2 * c2
        eta2 = c2 ** 2 * alpha
        d2 = axpy(y2, theta1 ** 2 * eta1 / nz(alpha), d1)
        x = axpy(x1, eta2, d2)
        rho1 = dot(rt, w2)
        beta = rho1 / nz(rho)
        y_next = axpy(w2, beta, y2)
        v = axpy(B.mult(A.mult(y_next)), beta, axpy(Ky2, beta, v))
        dp = tau2 * torch.sqrt(scalar(2.0 * (lp.its + 1.0), b))
        dp_h, sigma_h, rho_h = host(dp, sigma, rho)
        lp.step(dp_h, KR.DIVERGED_BREAKDOWN if sigma_h == 0 or rho_h == 0 else 0)
        w, y, d, tau, theta, eta, rho = w2, y_next, d2, tau2, theta2, eta2, rho1
    return SolveResult(x, lp.its, lp.rnd(float(tau)),
                       finalize_reason(lp.reason, lp.its, cfg), lp.hist, lp.dp0)


def solve_cr(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Conjugate residuals (cr.c): SPD A, the recursive residual r of B A
    minimized; the norm tested is ||r||."""
    r0 = initial_residual(A, b, x0, cfg)
    x = x0
    r = B.mult(r0)
    p = r
    Ap = A.mult(r)
    rAr = dot(r, Ap)
    lp = _Loop(cfg, b, float(dp_of(cfg.normtype, r0, r)), rtol, abstol, divtol)
    while lp.live():
        BAp = B.mult(Ap)
        denom = dot(Ap, BAp)
        alpha = rAr / nz(denom)
        x = axpy(x, alpha, p)
        r = axpy(r, -alpha, BAp)
        Ar = A.mult(r)
        rAr_ = dot(r, Ar)
        beta = rAr_ / nz(rAr)
        p = axpy(r, beta, p)
        Ap = axpy(Ar, beta, Ap)
        dp, denom_h = host(norm(r), denom)
        lp.step(dp, KR.DIVERGED_INDEFINITE_MAT if denom_h == 0 else 0)
        rAr = rAr_
    return lp.result(x)


def solve_gcr(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """GCR(m) (gcr.c): flexible, right preconditioned, restarted after m
    directions; each new A B r orthogonalized (classical Gram-Schmidt)
    against the cycle's normalized A-directions. cfg.extra = (restart, ...)."""
    m = int(cfg.extra[0]) if cfg.extra else 30
    n = b.numel()
    x = x0
    r = initial_residual(A, b, x0, cfg)
    lp = _Loop(cfg, b, float(norm(r)), rtol, abstol, divtol)
    S = torch.empty((m, n), dtype=b.dtype, device=b.device)
    V = torch.empty((m, n), dtype=b.dtype, device=b.device)
    neg_one = scalar(-1.0, b)
    first = True
    while first or lp.live():
        first = False
        k = 0
        while lp.reason == 0 and k < m and lp.its < cfg.max_it:
            sk = B.mult(r)
            vk = A.mult(sk)
            if k:
                h = torch.mv(V[:k], vk)
                vk = axpy(vk, neg_one, torch.mv(V[:k].t(), h))
                sk = axpy(sk, neg_one, torch.mv(S[:k].t(), h))
            nv = norm(vk)
            nvs = nz(nv)
            vk, sk = vk / nvs, sk / nvs
            alpha = dot(vk, r)
            x = axpy(x, alpha, sk)
            r = axpy(r, -alpha, vk)
            S[k], V[k] = sk, vk
            dp, nv_h = host(norm(r), nv)
            lp.step(dp, KR.DIVERGED_BREAKDOWN if nv_h == 0 else 0)
            k += 1
    return lp.result(x)


def _transpose_op(A):
    """A^T's product, or A's where the operator has no transpose (the
    reference's fallback: the operator is then taken as symmetric)."""
    return A.mult_t if A.mult_t is not None else A.mult


def solve_lsqr(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """LSQR (lsqr.c, Paige-Saunders Golub-Kahan bidiagonalization) for
    min ||A x - b||, with A^T's product (the PC is not applied); the norm
    is the recurrence's phibar."""
    At = _transpose_op(A)
    x = x0
    u = initial_residual(A, b, x, cfg)
    beta = norm(u)
    u = u / nz(beta)
    v = At(u)
    alpha = norm(v)
    v = v / nz(alpha)
    w = v
    phibar, rhobar = beta, alpha
    lp = _Loop(cfg, b, float(beta), rtol, abstol, divtol)
    while lp.live():
        u = axpy(A.mult(v), -alpha, u)
        beta = norm(u)
        u = u / nz(beta)
        v = axpy(At(u), -beta, v)
        alpha = norm(v)
        v = v / nz(alpha)
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        rho_s = nz(rho)
        c = rhobar / rho_s
        sn = beta / rho_s
        theta = sn * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = sn * phibar
        x = axpy(x, phi / rho_s, w)
        w = axpy(v, -(theta / rho_s), w)
        lp.step(float(phibar))
    return lp.result(x)


def solve_symmlq(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """SYMMLQ (Paige & Saunders; symmlq.c): symmetric, possibly indefinite
    A with an SPD preconditioner, the preconditioned Lanczos process and an
    LQ factorization; iterates follow the minimum-error point, and the
    solution moves to the CG point at the end. The norm is the residual
    estimate s_prod / |c|."""
    haptol = 1e-18
    x = x0
    r0 = initial_residual(A, b, x, cfg)
    z0 = B.mult(r0)
    dp_ = dot(r0, z0)
    beta1 = torch.sqrt(torch.abs(dp_))
    v, u = r0 / nz(beta1), z0 / nz(beta1)
    np0, dp_h = host(norm(z0), dp_)
    lp = _Loop(cfg, b, np0, rtol, abstol, divtol)
    if dp_h < 0:
        lp.reason = int(KR.DIVERGED_INDEFINITE_PC)
    zerov = torch.zeros_like(b)
    r, z = r0, z0
    vold, uold, w, wbar = zerov, zerov, zerov, u
    one, zero = torch.ones_like(beta1), torch.zeros_like(beta1)
    beta, c, s, cold, sold = beta1, one, zero, one, zero
    ceta, ceta_old, ceta_oold, s_prod = zero, zero, zero, torch.abs(beta1)
    while lp.live():
        first = lp.its == 0
        if not first:
            vold, uold = v, u
            v, u = r / nz(beta), z / nz(beta)
            w = axpy(c * wbar, s, u)
            wbar = axpy(-s * wbar, c, u)
            x = axpy(x, ceta, w)
            ceta_oold, ceta_old = ceta_old, ceta
        r = A.mult(u)
        alpha = dot(u, r)
        z = B.mult(r)
        r = axpy(axpy(r, -alpha, v), -beta, vold)
        z = axpy(axpy(z, -alpha, u), -beta, uold)
        betaold = beta
        dp = dot(r, z)
        happy = torch.abs(dp) < haptol
        indef = (dp < 0) & ~happy
        dp = torch.where(happy, zero, dp)
        beta = torch.sqrt(torch.abs(dp))
        coold, soold = cold, sold
        cold, sold = c, s
        rho0 = cold * alpha - coold * sold * betaold
        rho1 = torch.sqrt(rho0 * rho0 + beta * beta)
        rho2 = sold * alpha + coold * cold * betaold
        rho3 = soold * betaold
        c = rho0 / nz(rho1)
        s = beta / nz(rho1)
        if first:
            ceta = beta1 / nz(rho1)
        else:
            ceta = -(rho2 * ceta_old + rho3 * ceta_oold) / nz(rho1)
        s_prod = s_prod * torch.abs(s)
        np_ = torch.where(c == 0, s_prod * 1e16, s_prod / nz(torch.abs(c)))
        np_h, indef_h = host(np_, indef.to(b.dtype))
        lp.step(np_h, KR.DIVERGED_INDEFINITE_PC if indef_h else 0)
    if lp.its > 0:
        # the CG point: x + (ceta / c) wbar (symmlq.c's exit)
        ceta_bar = torch.where(c == 0, ceta * 1e15, ceta / nz(c))
        x = axpy(x, ceta_bar, wbar)
    return lp.result(x)


def solve_cgne(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """CGNE (cgne.c): CG on the normal equations A^T A x = A^T b without
    forming A^T A (A^T's product; A's where there is none, as the
    reference); the PC applies to the normal equations' residual and the
    norm is the natural one."""
    At = _transpose_op(A)
    bt = At(b)
    x = x0
    r = axpy(bt, scalar(-1.0, b), At(A.mult(x))) if cfg.guess_nonzero else bt
    z = B.mult(r)
    lp = _Loop(cfg, b, float(torch.sqrt(torch.abs(dot(z, r)))), rtol, abstol, divtol)
    p = torch.zeros_like(bt)
    beta_old = scalar(1.0, b)
    while lp.live():
        beta = dot(z, r)
        bcoef = torch.zeros_like(beta) if lp.its == 0 else beta / nz(beta_old)
        p = axpy(z, bcoef, p)
        Ap = At(A.mult(p))
        dpi = dot(p, Ap)
        a = beta / nz(dpi)
        x = axpy(x, a, p)
        r = axpy(r, -a, Ap)
        z = B.mult(r)
        dp, dpi_h = host(torch.sqrt(torch.abs(dot(z, r))), dpi)
        lp.step(dp, KR.DIVERGED_INDEFINITE_MAT if dpi_h <= 0 else 0)
        beta_old = beta
    return lp.result(x)


def solve_fcg(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Flexible CG (fcg.c, Notay): each direction A-orthogonalized against
    the last m stored (direction, A direction) pairs. cfg.extra =
    (mmax, ...); the norm is ||r||."""
    m = int(cfg.extra[0]) if cfg.extra else 30
    n = b.numel()
    x = x0
    r = initial_residual(A, b, x0, cfg)
    lp = _Loop(cfg, b, float(norm(r)), rtol, abstol, divtol)
    P = torch.zeros((m, n), dtype=b.dtype, device=b.device)
    Q = torch.zeros((m, n), dtype=b.dtype, device=b.device)
    den = torch.ones(m, dtype=b.dtype, device=b.device)
    neg_one = scalar(-1.0, b)
    while lp.live():
        z = B.mult(r)
        used = min(lp.its, m)
        if used:
            coeffs = torch.mv(Q[:used], z) / den[:used]
            p = axpy(z, neg_one, torch.mv(P[:used].t(), coeffs))
        else:
            p = z
        Ap = A.mult(p)
        pAp = dot(p, Ap)
        a = dot(p, r) / nz(pAp)
        x = axpy(x, a, p)
        r = axpy(r, -a, Ap)
        slot = lp.its % m
        P[slot], Q[slot], den[slot] = p, Ap, nz(pAp)
        dp, pAp_h = host(norm(r), pAp)
        lp.step(dp, KR.DIVERGED_INDEFINITE_MAT if pAp_h <= 0 else 0)
    return lp.result(x)


def solve_pipecg(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Pipelined CG (pipecg.c, Ghysels & Vanroose): the two reductions
    gamma = (r, u) and delta = (w, u) of one iteration side by side, and
    the products m = B w, n = A m independent of them. One product and one
    PC application per iteration."""
    x = x0
    r = initial_residual(A, b, x0, cfg)
    u = B.mult(r)
    w = A.mult(u)
    lp = _Loop(cfg, b, float(dp_of(cfg.normtype, r, u)), rtol, abstol, divtol)
    zeros = torch.zeros_like(b)
    z, q, p, sv = zeros, zeros, zeros, zeros
    alpha_old = gamma_old = scalar(1.0, b)
    while lp.live():
        gamma = dot(r, u)
        delta = dot(w, u)
        m2 = B.mult(w)
        n2 = A.mult(m2)
        if lp.its == 0:
            beta = torch.zeros_like(gamma)
            alpha = gamma / nz(delta)
        else:
            beta = gamma / nz(gamma_old)
            alpha = gamma / nz(delta - beta / nz(alpha_old) * gamma)
        z = axpy(n2, beta, z)
        q = axpy(m2, beta, q)
        p = axpy(u, beta, p)
        sv = axpy(w, beta, sv)
        x = axpy(x, alpha, p)
        u = axpy(u, -alpha, q)
        w = axpy(w, -alpha, z)
        r = axpy(r, -alpha, sv)
        lp.step(float(dp_of(cfg.normtype, r, u)))
        alpha_old, gamma_old = alpha, gamma
    return lp.result(x)
