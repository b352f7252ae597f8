"""More Tao types: bncg (and bqnls), owlqn and tron.

Counterpart of ``petsc_tpu/tao/impls_more.py`` (reference
src/tao/bound/impls/bncg, unconstrained/impls/owlqn with its
pseudo-gradient and orthant projection, bound/impls/tron's active-set
trust-region Newton). Tensors on the Vec's device, as in ``tao.py``.
"""

from __future__ import annotations

import math

import torch

from ..ops import vecops as V
from ..sys.error import TaoConvergedReason as TaoR
from .tao import Tao, _done, _lbfgs_dir, _project, _steihaug


def solve_bncg(tao: Tao, x, xvec):
    """Projected PRP+ nonlinear CG, restarted on an active-set change."""
    lb, ub = tao._lb, tao._ub
    x = _project(x, lb, ub)
    f, g = tao._fg(x)

    def pgnorm(xv, gv):
        return V.norm(xv - _project(xv - gv, lb, ub))

    gnorm = pgnorm(x, g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    d = -g
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    active = None
    while reason == TaoR.CONTINUE_ITERATING:
        t, ok = 1.0, False
        for _ in range(30):
            xn = _project(V.axpy(x, t, d), lb, ub)
            fx, gx = tao._fg(xn)
            if fx <= f + 1e-4 * V.dot(g, xn - x):
                ok = True
                break
            t *= 0.5
        if not ok:
            d = -g
            fail = True
            for _ in range(30):
                xn = _project(V.axpy(x, t, d), lb, ub)
                fx, gx = tao._fg(xn)
                if fx < f:
                    fail = False
                    break
                t *= 0.5
            if fail:
                reason = TaoR.DIVERGED_LS_FAILURE
                break
        new_active = ((xn <= lb + 1e-12) | (xn >= ub - 1e-12)) if lb is not None \
            else torch.zeros_like(xn, dtype=torch.bool)
        beta = max(0.0, V.dot(gx, V.axpy(gx, -1.0, g)) / max(V.normsq(g), 1e-300))
        if active is not None and bool((new_active != active).any()):
            beta = 0.0   # restart on an active-set change
        d = V.axpy(-gx, beta, d)
        active = new_active
        x, f, g = xn, fx, gx
        gnorm = pgnorm(x, g)
        it += 1
        tao._monitor(it, f, gnorm)
        reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def solve_owlqn(tao: Tao, x, xvec):
    """Orthant-wise limited-memory quasi-Newton for min f(x) + lam ||x||_1
    (owlqn.c; lam from setRegularizerWeight): the pseudo-gradient picks the
    steepest-descent subgradient, the search stays in the orthant."""
    lam = tao._reg if tao._reg else 1.0
    m = 10
    S, Y = [], []

    def pseudo_grad(xv, gv):
        zero = torch.zeros_like(gv)
        pg = torch.where(xv > 0, gv + lam, torch.where(xv < 0, gv - lam, zero))
        at0 = xv == 0
        pg = torch.where(at0 & (gv + lam < 0), gv + lam, pg)
        return torch.where(at0 & (gv - lam > 0), gv - lam, pg)

    def fval(xv):
        f, g = tao._fg(xv)
        return f + lam * float(xv.abs().sum()), g

    f, g = fval(x)
    pg = pseudo_grad(x, g)
    gnorm = V.norm(pg)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        d = -_lbfgs_dir(S, Y, pg)
        d = torch.where(d * -pg > 0, d, torch.zeros_like(d))
        if not bool(d.any()):
            d = -pg
        orthant = torch.where(x != 0, torch.sign(x), torch.sign(-pg))
        t, ok = 1.0, False
        pgsq = V.normsq(pg)
        for _ in range(40):
            xn = V.axpy(x, t, d)
            xn = torch.where(torch.sign(xn) == orthant, xn, torch.zeros_like(xn))
            fx, gx = fval(xn)
            if fx <= f - 1e-4 * t * pgsq:
                ok = True
                break
            t *= 0.5
        if not ok:
            reason = TaoR.DIVERGED_LS_FAILURE if it == 0 else TaoR.CONVERGED_STEPTOL
            break
        s_new, y_new = V.axpy(xn, -1.0, x), V.axpy(pseudo_grad(xn, gx), -1.0, pg)
        if V.dot(s_new, y_new) > 1e-14:
            S.append(s_new)
            Y.append(y_new)
            if len(S) > m:
                S.pop(0)
                Y.pop(0)
        x, f, g = xn, fx, gx
        pg = pseudo_grad(x, g)
        gnorm = V.norm(pg)
        it += 1
        tao._monitor(it, f, gnorm)
        reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def solve_tron(tao: Tao, x, xvec):
    """TRON (tron.c): trust-region Newton for bound constraints; the
    projected gradient defines the active set, Steihaug on the free
    variables."""
    lb, ub = tao._lb, tao._ub
    x = _project(x, lb, ub)
    f, g = tao._fg(x)

    def pgnorm(xv, gv):
        return V.norm(xv - _project(xv - gv, lb, ub))

    gnorm = pgnorm(x, g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    delta = max(1.0, 0.1 * V.norm(x))
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        hmv = tao._hessmult(x)
        free = ~(((x <= lb + 1e-12) & (g > 0)) | ((x >= ub - 1e-12) & (g < 0))) \
            if lb is not None else torch.ones_like(x, dtype=torch.bool)
        zero = torch.zeros_like(x)

        def hmv_free(v, free=free, hmv=hmv, zero=zero):
            return torch.where(free, hmv(torch.where(free, v, zero)), v)

        d = _steihaug(hmv_free, -torch.where(free, g, zero), delta,
                      tol=min(0.5, math.sqrt(gnorm)) * gnorm)
        xn = _project(V.axpy(x, 1.0, d), lb, ub)
        fx, gx = tao._fg(xn)
        s = V.axpy(xn, -1.0, x)
        pred = -(V.dot(g, s) + 0.5 * V.dot(s, hmv(s)))
        ared = f - fx
        rho = ared / pred if pred > 0 else (1.0 if ared > 0 else -1.0)
        if rho < 0.25:
            delta *= 0.25
        elif rho > 0.75:
            delta = min(2 * delta, 1e10)
        if ared > 0:
            x, f, g = xn, fx, gx
            gnorm = pgnorm(x, g)
            it += 1
            tao._monitor(it, f, gnorm)
            reason = tao._check(it, f, gnorm, g0norm)
        elif delta < 1e-30:
            reason = TaoR.DIVERGED_TR_REDUCTION
    _done(tao, xvec, x, it, f, gnorm, reason)


Tao._impls.update({
    "bncg": solve_bncg,
    "owlqn": solve_owlqn,
    "tron": solve_tron,
    "bqnls": solve_bncg,   # the projected-QN role served by bncg
})
