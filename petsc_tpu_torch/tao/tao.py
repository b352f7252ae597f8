"""Tao: optimization solvers.

Counterpart of ``petsc_tpu/tao/tao.py`` (reference src/tao/: TaoSolve
interface/taosolver.c:170; unconstrained lmvm, nls, ntr, ntl, cg,
neldermead, bmrm; bound blmvm; leastsquares brgn and pounders;
complementarity ssils and its aliases; constrained almm, pdipm/ipm;
pde_constrained lcl; the Wolfe line search's role of TaoLineSearch).

Objectives are pure torch functions: gradients and Hessian actions are
exact, by reverse mode (``ops/autodiff.py``: one backward a gradient, the
gradient's graph kept for the Hessian actions at an iterate, Newton-CG
without forming the Hessian), Gauss-Newton products from jvp/vjp of the
residual (``torch.func``). The iterate, gradient and directions are
tensors on the Vec's device; inner products and norms run on K4, updates
on K2, and each scalar the loop tests is one host read. Dense work on
small problems (the KKT systems of pdipm, ssils' Newton matrix, lcl's
state Jacobians, bmrm's dual QP, pounders' model, Nelder-Mead's simplex)
stays on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import vecops as V
from ..ops.autodiff import HessianAction, value_and_grad
from ..sys.error import Error, TaoConvergedReason as TaoR
from ..sys.object import PObject
from ..vec.vec import Vec


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class Tao(PObject):
    _class_name = "Tao"
    _impls = {}

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self._type = "lmvm"
        self.gatol, self.grtol, self.gttol = 1e-8, 1e-8, 0.0
        self.max_it, self.max_funcs = 2000, 10000
        self._obj = None          # pure f(x) -> scalar
        self._grad = None         # optional pure g(x) -> tensor
        self._residual = None     # pure r(x) -> tensor (least squares)
        self._hess = None         # optional x -> (v -> H(x) v)
        self._lb = None
        self._ub = None
        self._reg = 0.0           # brgn Tikhonov weight
        self._its = 0
        self._fval = 0.0
        self._gnorm = 0.0
        self._reason = TaoR.CONTINUE_ITERATING
        self._history = []
        self._monitors = []
        self._nfuncs = 0
        self._reset_logs()

    def _reset_logs(self):
        """What each step of the last solve did: per Wolfe search (a
        descent direction, its trial points, its curvature tests); per
        L-BFGS direction the pairs it used; per Newton-CG solve (Hessian
        products, whether negative curvature ended it)."""
        self._ls_its = []
        self._lbfgs_pairs = []
        self._cg_its = []

    # ---------------- set-up ----------------

    def create(self, comm=None):
        self.comm = comm or self.comm
        return self

    def setType(self, t):
        if t not in self._impls:
            raise KeyError(f"unknown Tao type '{t}'; have "
                           f"{sorted(self._impls)}")
        self._type = t
        return self

    def getType(self):
        return self._type

    def setObjective(self, fn):
        """Pure torch scalar objective f(x)."""
        self._obj = fn
        return self

    def setGradient(self, fn):
        self._grad = fn
        return self

    def setObjectiveGradient(self, fn_obj, fn_grad=None):
        self._obj = fn_obj
        self._grad = fn_grad
        return self

    def setResidual(self, fn):
        """Least-squares residual r(x) (TaoSetResidualRoutine; brgn)."""
        self._residual = fn
        if self._obj is None:
            self._obj = lambda x: 0.5 * torch.sum(fn(x) ** 2)
        return self

    def setRegularizerWeight(self, w):
        self._reg = float(w)

    def setConstraints(self, fn):
        """TaoSetConstraintsRoutine: pure c(x) (ssils/ssfls, lcl)."""
        self._constraints = fn
        return self

    def setVariableBounds(self, lb, ub):
        self._lb = V.as_tensor(lb.array if isinstance(lb, Vec) else lb)
        self._ub = V.as_tensor(ub.array if isinstance(ub, Vec) else ub)
        return self

    def setTolerances(self, gatol=None, grtol=None, gttol=None):
        if gatol is not None:
            self.gatol = gatol
        if grtol is not None:
            self.grtol = grtol
        if gttol is not None:
            self.gttol = gttol
        return self

    def setMaximumIterations(self, n):
        self.max_it = int(n)

    def setFromOptions(self):
        t = self.opt("get_string", "tao_type", None)
        if t:
            self.setType(t)
        for name in ("gatol", "grtol", "gttol"):
            v = self.opt("get_real", f"tao_{name}", None)
            if v is not None:
                setattr(self, name, v)
        n = self.opt("get_int", "tao_max_it", None)
        if n:
            self.max_it = n
        return self

    def setMonitor(self, fn):
        self._monitors.append(fn)

    # ---------------- evaluation ----------------

    def _fg(self, x):
        """(f as a float, g as a tensor): the user's gradient, else one
        backward pass (ops/autodiff.py)."""
        self._nfuncs += 1
        if self._grad is not None:
            return float(self._obj(x)), V.flat(self._grad(x))
        return value_and_grad(self._obj, x)

    def _hessmult(self, x):
        """v -> H(x) v, exact and matrix-free: the jvp of the user's
        gradient, else the gradient's graph at x kept and one backward
        pass a product (ops/autodiff.py)."""
        if self._hess is not None:
            return self._hess(x)
        if self._grad is None:
            return HessianAction(self._obj, x)
        gfun, x0 = self._grad, x.detach()

        def hmv(v):
            return V.flat(torch.func.jvp(gfun, (x0,), (V.flat(v),))[1])
        return hmv

    # ---------------- convergence ----------------

    def _check(self, it, f, gnorm, gnorm0):
        if np.isnan(f) or np.isnan(gnorm):
            return TaoR.DIVERGED_NAN
        if gnorm <= self.gatol:
            return TaoR.CONVERGED_GATOL
        if f != 0 and abs(gnorm / f) <= self.grtol:
            return TaoR.CONVERGED_GRTOL
        if gnorm0 > 0 and self.gttol > 0 and gnorm / gnorm0 <= self.gttol:
            return TaoR.CONVERGED_GTTOL
        if it >= self.max_it:
            return TaoR.DIVERGED_MAXITS
        if self._nfuncs >= self.max_funcs:
            return TaoR.DIVERGED_MAXFCN
        return TaoR.CONTINUE_ITERATING

    def _monitor(self, it, f, gnorm):
        self._history.append((f, gnorm))
        if self.opt("get_bool", "tao_monitor", False):
            print(f"{it:3d} TAO,  Function value: {f:g},  Residual: {gnorm:g}")
        for m in self._monitors:
            m(self, it, f, gnorm)

    # ---------------- drive ----------------

    def solve(self, x: Vec):
        self.setFromOptions()
        self._history = []
        self._nfuncs = 0
        self._reset_logs()
        self._reason = TaoR.CONTINUE_ITERATING
        self._impls[self._type](self, V.flat(x.array).clone(), x)
        if self.opt("get_bool", "tao_converged_reason", False):
            print(f"TAO solve converged due to {self._reason.name} "
                  f"iterations {self._its}")
        return x

    def getIterationNumber(self):
        return self._its

    def getObjectiveValue(self):
        return self._fval

    getFunctionValue = getObjectiveValue

    def getGradientNorm(self):
        return self._gnorm

    def getConvergedReason(self):
        return self._reason

    def view(self, viewer=None):
        print(f"Tao Object: type: {self._type}")
        print(f"  convergence tolerances: gatol={self.gatol:g}, "
              f"grtol={self.grtol:g}, gttol={self.gttol:g}")
        print(f"  total number of iterations={self._its}")


def _done(tao, xvec, x, it, f, gnorm, reason):
    tao._its, tao._fval, tao._gnorm, tao._reason = it, f, gnorm, reason
    xvec.array = V.as_tensor(x, like=xvec.array).reshape(xvec.array.shape)


# =====================================================================
# line search (strong-Wolfe backtracking with interpolation, the role of
# TaoLineSearch more-thuente / armijo)
# =====================================================================

def _wolfe_ls(tao, x, f0, g0, d, c1=1e-4, c2=0.9, max_its=25, t0=1.0):
    """(x_new, f_new, g_new, t, ok) along the descent direction d
    (x_new = x + t d)."""
    dphi0 = V.dot(g0, d)
    if dphi0 >= 0:
        tao._ls_its.append((False, 0, 0))
        return x, f0, g0, 0.0, False
    log = [True, 0, 0]
    tao._ls_its.append(log)
    t, tmin, tmax = t0, 0.0, np.inf
    f_prev, t_prev = f0, 0.0
    for _ in range(max_its):
        log[1] += 1
        fx, gx = tao._fg(V.axpy(x, t, d))
        if not np.isfinite(fx) or fx > f0 + c1 * t * dphi0 \
                or (t_prev > 0 and fx >= f_prev):
            tmax = t
            t = 0.5 * (tmin + tmax)
            continue
        log[2] += 1
        dphi = V.dot(gx, d)
        if abs(dphi) <= c2 * abs(dphi0):
            return V.axpy(x, t, d), fx, gx, t, True
        if dphi >= 0:
            tmax = t
            t = 0.5 * (tmin + tmax)
        else:
            tmin = t
            t = 2.0 * t if not np.isfinite(tmax) else 0.5 * (tmin + tmax)
        f_prev, t_prev = fx, t
    xn = V.axpy(x, t, d)
    fx, gx = tao._fg(xn)
    return xn, fx, gx, t, fx < f0


def _project(x, lb, ub):
    if lb is not None:
        x = torch.maximum(x, lb)
    if ub is not None:
        x = torch.minimum(x, ub)
    return x


# =====================================================================
# implementations
# =====================================================================

def _lbfgs_dir(S, Y, g):
    """H g by the L-BFGS two-loop recursion (snes/snes.py's)."""
    from ..snes.snes import lbfgs_two_loop
    return lbfgs_two_loop(S, Y, g)


def solve_lmvm(tao: Tao, x, xvec, bounded=False):
    """L-BFGS (impls/lmvm; blmvm the gradient-projection variant)."""
    m = 10
    lb, ub = (tao._lb, tao._ub) if bounded else (None, None)
    x = _project(x, lb, ub)
    f, g = tao._fg(x)

    def gn(xv, gv):
        return V.norm(xv - _project(xv - gv, lb, ub)) if bounded else V.norm(gv)

    gnorm = gn(x, g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    S, Y = [], []
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        tao._lbfgs_pairs.append(len(S))
        d = -_lbfgs_dir(S, Y, g)
        if V.dot(d, g) >= 0:
            S.clear()
            Y.clear()
            d = -g
        if bounded:
            xn = _project(V.axpy(x, 1.0, d), lb, ub)
            fx, gx = tao._fg(xn)
            t = 1.0
            while fx > f - 1e-4 * V.dot(g, x - xn) and t > 1e-12:
                t *= 0.5
                xn = _project(V.axpy(x, t, d), lb, ub)
                fx, gx = tao._fg(xn)
            ok = fx < f
        else:
            xn, fx, gx, t, ok = _wolfe_ls(tao, x, f, g, d)
        if not ok:
            if len(S) == 0:
                reason = TaoR.DIVERGED_LS_FAILURE
                break
            S.clear()
            Y.clear()
            continue
        s_new, y_new = V.axpy(xn, -1.0, x), V.axpy(gx, -1.0, g)
        if V.dot(s_new, y_new) > 1e-14:
            S.append(s_new)
            Y.append(y_new)
            if len(S) > m:
                S.pop(0)
                Y.pop(0)
        x, f, g = xn, fx, gx
        gnorm = gn(x, g)
        it += 1
        tao._monitor(it, f, gnorm)
        reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def solve_blmvm(tao, x, xvec):
    solve_lmvm(tao, x, xvec, bounded=True)


def solve_nls(tao: Tao, x, xvec):
    """Newton line search with CG on exact Hessian actions (impls/nls;
    Steihaug-style exit on negative curvature)."""
    f, g = tao._fg(x)
    gnorm = V.norm(g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        hmv = tao._hessmult(x)
        d = _cg_hess(hmv, -g, tol=min(0.5, math.sqrt(gnorm)) * gnorm, log=tao._cg_its)
        if V.dot(d, g) >= 0:
            d = -g
        xn, fx, gx, t, ok = _wolfe_ls(tao, x, f, g, d)
        if not ok:
            xn, fx, gx, t, ok = _wolfe_ls(tao, x, f, g, -g)
            if not ok:
                reason = TaoR.DIVERGED_LS_FAILURE
                break
        x, f, g = xn, fx, gx
        gnorm = V.norm(g)
        it += 1
        tao._monitor(it, f, gnorm)
        reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def _cg_hess(hmv, b, tol, max_it=200, log=None):
    """CG on H d = b, truncated at negative curvature (Newton-CG); appends
    (Hessian products, ended by negative curvature) to `log`."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = V.normsq(r)
    moved = False
    products, negative = 0, False
    for _ in range(max_it):
        if math.sqrt(rr) <= tol:
            break
        Hp = hmv(p)
        products += 1
        pHp = V.dot(p, Hp)
        if pHp <= 0:
            negative = True
            if not moved:
                x = b
            break
        a = rr / pHp
        x = V.axpy(x, a, p)
        moved = moved or a != 0.0
        r = V.axpy(r, -a, Hp)
        rr_new = V.normsq(r)
        p = V.axpy(r, rr_new / rr, p)
        rr = rr_new
    if log is not None:
        log.append((products, negative))
    return x


def _tr_update(delta, rho, dnorm, boundary_test=True):
    if rho < 0.25:
        return delta * 0.25
    if rho > 0.75 and (not boundary_test or abs(dnorm - delta) < 1e-10):
        return min(2 * delta, 1e10)
    return delta


def solve_ntr(tao: Tao, x, xvec):
    """Newton trust region (impls/ntr): Steihaug-Toint CG on the
    subproblem, the standard radius update."""
    f, g = tao._fg(x)
    gnorm = V.norm(g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    delta = max(1.0, 0.1 * V.norm(x))
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        hmv = tao._hessmult(x)
        d = _steihaug(hmv, -g, delta, tol=min(0.5, math.sqrt(gnorm)) * gnorm)
        xn = V.axpy(x, 1.0, d)
        fx, gx = tao._fg(xn)
        pred = -(V.dot(g, d) + 0.5 * V.dot(d, hmv(d)))
        rho = (f - fx) / pred if pred > 0 else -1.0
        delta = _tr_update(delta, rho, V.norm(d))
        if rho > 1e-4 and np.isfinite(fx):
            x, f, g = xn, fx, gx
            gnorm = V.norm(g)
            it += 1
            tao._monitor(it, f, gnorm)
            reason = tao._check(it, f, gnorm, g0norm)
        elif delta < 1e-30:
            reason = TaoR.DIVERGED_TR_REDUCTION
        else:
            reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def solve_ntl(tao: Tao, x, xvec):
    """Newton trust region with a line-search fallback (impls/ntl/ntl.c):
    a rejected step is salvaged by a Wolfe search along it."""
    f, g = tao._fg(x)
    gnorm = V.norm(g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    delta = max(1.0, 0.1 * V.norm(x))
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        hmv = tao._hessmult(x)
        d = _steihaug(hmv, -g, delta, tol=min(0.5, math.sqrt(gnorm)) * gnorm)
        xn = V.axpy(x, 1.0, d)
        fx, gx = tao._fg(xn)
        gd = V.dot(g, d)
        pred = -(gd + 0.5 * V.dot(d, hmv(d)))
        rho = (f - fx) / pred if pred > 0 else -1.0
        accepted = rho > 1e-4 and np.isfinite(fx)
        if not accepted and gd < 0:
            xw, fw, gw, t, ok = _wolfe_ls(tao, x, f, g, d)
            if ok and fw < f:
                xn, fx, gx = xw, fw, gw
                accepted = True
        delta = _tr_update(delta, rho, V.norm(d))
        if accepted:
            x, f, g = xn, fx, gx
            gnorm = V.norm(g)
            it += 1
            tao._monitor(it, f, gnorm)
            reason = tao._check(it, f, gnorm, g0norm)
        elif delta < 1e-30:
            reason = TaoR.DIVERGED_TR_REDUCTION
        else:
            reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def _steihaug(hmv, b, delta, tol, max_it=200):
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = V.normsq(r)
    for _ in range(max_it):
        if math.sqrt(rr) <= tol:
            break
        Hp = hmv(p)
        pHp = V.dot(p, Hp)
        if pHp <= 0:
            return V.axpy(x, _to_boundary(x, p, delta), p)
        a = rr / pHp
        if V.norm(V.axpy(x, a, p)) >= delta:
            return V.axpy(x, _to_boundary(x, p, delta), p)
        x = V.axpy(x, a, p)
        r = V.axpy(r, -a, Hp)
        rr_new = V.normsq(r)
        p = V.axpy(r, rr_new / rr, p)
        rr = rr_new
    return x


def _to_boundary(x, p, delta):
    pp = V.normsq(p)
    xp = V.dot(x, p)
    xx = V.normsq(x)
    return (-xp + math.sqrt(max(xp * xp + pp * (delta * delta - xx), 0.0))) / pp


def solve_cg(tao: Tao, x, xvec):
    """Nonlinear CG, PRP+ with restart (impls/cg)."""
    f, g = tao._fg(x)
    gnorm = V.norm(g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    d = -g
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        xn, fx, gx, t, ok = _wolfe_ls(tao, x, f, g, d, c2=0.4)
        if not ok:
            d = -g
            xn, fx, gx, t, ok = _wolfe_ls(tao, x, f, g, d, c2=0.4)
            if not ok:
                reason = TaoR.DIVERGED_LS_FAILURE
                break
        beta = max(0.0, V.dot(gx, V.axpy(gx, -1.0, g)) / V.normsq(g))
        d = V.axpy(-gx, beta, d)
        x, f, g = xn, fx, gx
        gnorm = V.norm(g)
        it += 1
        tao._monitor(it, f, gnorm)
        reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def solve_brgn(tao: Tao, x, xvec):
    """Regularised Gauss-Newton for least squares (leastsquares/impls/
    brgn): min 0.5||r(x)||^2 + 0.5 reg ||x||^2, the step by CG on
    (J^T J + reg I) d = -(J^T r + reg x) with jvp/vjp products."""
    if tao._residual is None:
        raise Error("brgn: call setResidual first")
    rfun = tao._residual
    reg = tao._reg
    f, g = tao._fg(x)
    if reg:
        f += 0.5 * reg * V.normsq(x)
        g = V.axpy(g, reg, x)
    gnorm = V.norm(g)
    g0norm = gnorm
    tao._monitor(0, f, gnorm)
    it = 0
    reason = tao._check(0, f, gnorm, g0norm)
    while reason == TaoR.CONTINUE_ITERATING:
        x0 = x.detach()
        _, vjp = torch.func.vjp(rfun, x0)

        def jtj(v, x0=x0, vjp=vjp):
            jv = torch.func.jvp(rfun, (x0,), (v,))[1]
            return V.axpy(V.flat(vjp(jv)[0]), reg, v)

        d = _cg_hess(jtj, -g, tol=1e-2 * gnorm)
        xn, fx, gx, t, ok = _wolfe_ls(tao, x, f, g, d)
        if reg:
            fx += 0.5 * reg * V.normsq(xn)
            gx = V.axpy(gx, reg, xn)
        if not ok:
            reason = TaoR.DIVERGED_LS_FAILURE
            break
        x, f, g = xn, fx, gx
        gnorm = V.norm(g)
        it += 1
        tao._monitor(it, f, gnorm)
        reason = tao._check(it, f, gnorm, g0norm)
    _done(tao, xvec, x, it, f, gnorm, reason)


def solve_almm(tao: Tao, x, xvec):
    """Augmented Lagrangian multiplier method (constrained/impls/almm):
    min f(x) s.t. g(x) = 0, h(x) <= 0 (setEqualityConstraints,
    setInequalityConstraints), lmvm subproblems and the classic
    multiplier and penalty updates."""
    g = getattr(tao, "_eq", None)
    h = getattr(tao, "_ineq", None)
    if g is None and h is None:
        raise Error("almm: set equality/inequality constraints first")
    mu = 10.0
    lam_eq = lam_in = None
    f_obj = tao._obj
    x_cur = x.clone()
    outer_its = 0
    for outer in range(30):
        geval = V.flat(g(x_cur)) if g else torch.zeros(0, dtype=x.dtype, device=x.device)
        heval = V.flat(h(x_cur)) if h else torch.zeros(0, dtype=x.dtype, device=x.device)
        if lam_eq is None:
            lam_eq = torch.zeros_like(geval)
            lam_in = torch.zeros_like(heval)
        viol = max(float(geval.abs().max()) if geval.numel() else 0.0,
                   float(torch.clamp(heval, min=0.0).max()) if heval.numel() else 0.0)
        if viol < tao.gatol * 10 and outer > 0:
            break

        def aug(z, le=lam_eq, li=lam_in, muj=mu):
            val = f_obj(z)
            if g is not None:
                gz = g(z)
                val = val + torch.sum(le * gz) + 0.5 * muj * torch.sum(gz ** 2)
            if h is not None:
                hz = h(z)
                s = torch.clamp(li / muj + hz, min=0.0)
                val = val + 0.5 * muj * torch.sum(s ** 2 - (li / muj) ** 2)
            return val

        sub = Tao(options=tao._options)
        sub.create(tao.comm)
        sub.setType("lmvm")
        sub.setObjective(aug)
        sub.setTolerances(gatol=max(tao.gatol, 1e-2 / (10 ** outer)))
        sub.setMaximumIterations(200)
        xv = Vec.from_array(x_cur, comm=tao.comm)
        sub.solve(xv)
        x_cur = V.flat(xv.array)
        outer_its += sub.getIterationNumber()
        if g is not None:
            lam_eq = lam_eq + mu * V.flat(g(x_cur))
        if h is not None:
            lam_in = torch.clamp(lam_in + mu * V.flat(h(x_cur)), min=0.0)
        mu = min(mu * 4.0, 1e8)
    f, gr = tao._fg(x_cur)
    _done(tao, xvec, x_cur, outer_its, f, V.norm(gr), TaoR.CONVERGED_USER)


def setEqualityConstraints(tao, fn):
    tao._eq = fn
    return tao


def setInequalityConstraints(tao, fn):
    tao._ineq = fn
    return tao


Tao.setEqualityConstraints = setEqualityConstraints
Tao.setInequalityConstraints = setInequalityConstraints


def solve_neldermead(tao: Tao, x, xvec):
    """Derivative-free simplex (impls/neldermead): scipy's Nelder-Mead on
    the host, each objective one evaluation on the device."""
    from scipy.optimize import minimize
    res = minimize(lambda z: float(tao._obj(V.as_tensor(z, like=x))), _host(x),
                   method="Nelder-Mead",
                   options={"maxiter": tao.max_it, "xatol": tao.gatol,
                            "fatol": tao.gatol})
    tao._its = res.nit
    tao._fval = float(res.fun)
    tao._gnorm = 0.0
    tao._reason = TaoR.CONVERGED_USER if res.success else TaoR.DIVERGED_MAXITS
    xvec.array = V.as_tensor(res.x, like=xvec.array)


def _fischer_burmeister(a, b):
    return torch.sqrt(a * a + b * b + 1e-300) - a - b


def solve_ssils(tao: Tao, x, xvec):
    """Semismooth infeasible line search for the NCP 0 <= x _|_ F(x) >= 0
    (complementarity/impls/ssls/ssils.c): Newton on the Fischer-Burmeister
    reformulation with an Armijo search on 0.5||Phi||^2; the generalised
    Jacobian from torch.func.jacfwd, solved on the host."""
    F = getattr(tao, "_constraints", None)
    if F is None:
        raise Error("ssils: call setConstraints first")

    def Phi(z):
        return _fischer_burmeister(z, V.flat(F(z)))

    def merit(z):
        return 0.5 * V.normsq(Phi(z))

    it = 0
    reason = TaoR.CONTINUE_ITERATING
    xk = x
    m = merit(xk)
    gnorm = math.sqrt(2 * m)
    g0 = max(gnorm, 1e-300)
    tao._monitor(0, m, gnorm)
    while it < tao.max_it:
        if gnorm <= tao.gatol or gnorm / g0 <= tao.grtol:
            reason = TaoR.CONVERGED_GATOL
            break
        P = _host(Phi(xk))
        J = _host(torch.func.jacfwd(Phi)(xk))
        try:
            d = np.linalg.solve(J + 1e-12 * np.eye(len(P)), -P)
        except np.linalg.LinAlgError:
            d, *_ = np.linalg.lstsq(J, -P, rcond=None)
        d = V.as_tensor(d, like=xk)
        t = 1.0
        ok = False
        for _ in range(30):
            if merit(V.axpy(xk, t, d)) <= (1 - 1e-4 * t) * m:
                ok = True
                break
            t *= 0.5
        if not ok:
            reason = TaoR.DIVERGED_LS_FAILURE
            break
        xk = V.axpy(xk, t, d)
        m = merit(xk)
        gnorm = math.sqrt(2 * m)
        it += 1
        tao._monitor(it, m, gnorm)
    else:
        reason = TaoR.DIVERGED_MAXITS
    if reason == TaoR.CONTINUE_ITERATING:
        reason = TaoR.CONVERGED_GATOL
    _done(tao, xvec, xk, it, m, gnorm, reason)


def solve_pdipm(tao: Tao, x, xvec):
    """Primal-dual interior point for bound-constrained minimisation
    (constrained/impls/ipm/pdipm.c role): a log barrier on the bounds,
    Newton on the perturbed KKT system with fraction-to-the-boundary
    steps, mu from the complementarity average. Gradient and dense
    Hessian from torch.func; the KKT algebra on the host."""
    n = x.numel()
    lb = np.full(n, -np.inf) if tao._lb is None else _host(tao._lb)
    ub = np.full(n, np.inf) if tao._ub is None else _host(tao._ub)
    has_lb = np.isfinite(lb)
    has_ub = np.isfinite(ub)
    xk = np.clip(_host(x), np.where(has_lb, lb + 1e-2, -np.inf),
                 np.where(has_ub, ub - 1e-2, np.inf))
    zl = np.where(has_lb, 1.0, 0.0)
    zu = np.where(has_ub, 1.0, 0.0)
    obj = tao._obj
    grad_fn = torch.func.grad(obj)
    hess_fn = torch.func.hessian(obj)

    def dev(a):
        return V.as_tensor(a, like=x)

    mu = 1.0
    it = 0
    reason = TaoR.CONTINUE_ITERATING
    gnorm = 0.0
    while it < tao.max_it:
        g = _host(grad_fn(dev(xk)))
        rd = g - zl + zu
        sl = np.where(has_lb, xk - lb, 1.0)
        su = np.where(has_ub, ub - xk, 1.0)
        rcl = np.where(has_lb, sl * zl - mu, 0.0)
        rcu = np.where(has_ub, su * zu - mu, 0.0)
        kkt = np.linalg.norm(np.concatenate([rd, rcl, rcu]))
        gnorm = float(np.linalg.norm(rd))
        tao._monitor(it, float(obj(dev(xk))), kkt)
        if kkt <= tao.gatol:
            reason = TaoR.CONVERGED_GATOL
            break
        H = _host(hess_fn(dev(xk)))
        sl = np.where(has_lb, np.maximum(sl, 1e-300), 1.0)
        su = np.where(has_ub, np.maximum(su, 1e-300), 1.0)
        D = np.where(has_lb, zl / sl, 0.0) + np.where(has_ub, zu / su, 0.0)
        rd_bar = rd + np.where(has_lb, rcl / sl, 0.0) - np.where(has_ub, rcu / su, 0.0)
        dx = np.linalg.solve(H + np.diag(D) + 1e-12 * np.eye(n), -rd_bar)
        dzl = np.where(has_lb, -(rcl + zl * dx) / sl, 0.0)
        dzu = np.where(has_ub, -(rcu - zu * dx) / su, 0.0)
        tau = 0.995

        def maxstep(v, dv):
            neg = dv < 0
            return float(min(1.0, np.min(np.where(neg, -tau * v / np.where(neg, dv, -1.0),
                                                  1.0)))) if neg.any() else 1.0

        ap = min(maxstep(sl[has_lb], dx[has_lb]) if has_lb.any() else 1.0,
                 maxstep(su[has_ub], -dx[has_ub]) if has_ub.any() else 1.0)
        ad = min(maxstep(zl[has_lb], dzl[has_lb]) if has_lb.any() else 1.0,
                 maxstep(zu[has_ub], dzu[has_ub]) if has_ub.any() else 1.0)
        xk = xk + ap * dx
        zl = zl + ad * dzl
        zu = zu + ad * dzu
        nact = max(int(has_lb.sum() + has_ub.sum()), 1)
        mu_est = (np.where(has_lb, (xk - lb) * zl, 0.0).sum()
                  + np.where(has_ub, (ub - xk) * zu, 0.0).sum()) / nact
        mu = max(min(0.2 * mu_est, mu * 0.9), 1e-16)
        it += 1
    else:
        reason = TaoR.DIVERGED_MAXITS
    if reason == TaoR.CONTINUE_ITERATING:
        reason = TaoR.CONVERGED_GATOL
    _done(tao, xvec, xk, it, float(obj(dev(xk))), gnorm, reason)


def solve_lcl(tao: Tao, x, xvec):
    """Linearly constrained Lagrangian (pde_constrained/impls/lcl) on the
    split [design d | state u] (tao.n_design), in reduced space: the
    state by Newton on c(d, .) = 0, the reduced gradient by the adjoint
    method (torch.func for the Jacobians, the small solves on the host),
    the design by L-BFGS with Armijo."""
    con = getattr(tao, "_constraints", None)
    if con is None:
        raise Error("lcl: setConstraints(c(d, u)) first")
    nd = getattr(tao, "n_design", None)
    if nd is None:
        raise Error("lcl: set tao.n_design (leading design dofs)")
    obj = tao._obj

    def c_of(d, u):
        return V.flat(con(torch.cat([d, u])))

    def f_of(d, u):
        return obj(torch.cat([d, u]))

    cu = torch.func.jacfwd(c_of, argnums=1)
    cd = torch.func.jacfwd(c_of, argnums=0)
    fd_fu = torch.func.grad(f_of, argnums=(0, 1))

    def dev(a):
        return V.as_tensor(a, like=x)

    def state_solve(d, u0):
        u = u0
        for _ in range(30):
            r = _host(c_of(d, u))
            if np.linalg.norm(r) < 1e-12:
                break
            u = u - dev(np.linalg.solve(_host(cu(d, u)), r))
        return u

    def reduced(d, u0):
        dt_ = dev(d)
        u = state_solve(dt_, u0)
        f = float(f_of(dt_, u))
        gd, gu = fd_fu(dt_, u)
        lam = np.linalg.solve(_host(cu(dt_, u)).T, _host(gu))
        g = _host(gd) - _host(cd(dt_, u)).T @ lam
        return f, g, u

    xh = _host(x)
    d = xh[:nd].copy()
    u = dev(xh[nd:])
    S, Y = [], []
    f, g, u = reduced(d, u)
    gnorm = float(np.linalg.norm(g))
    g0 = max(gnorm, 1e-300)
    tao._monitor(0, f, gnorm)
    it = 0
    reason = TaoR.CONTINUE_ITERATING
    while it < tao.max_it:
        if gnorm <= tao.gatol or gnorm / g0 <= tao.grtol:
            reason = TaoR.CONVERGED_GATOL
            break
        p = -_host(_lbfgs_dir([dev(s) for s in S], [dev(y) for y in Y], dev(g))) if S else -g
        if float(np.dot(p, g)) >= 0:
            p = -g
        t = 1.0
        ok = False
        for _ in range(30):
            fn_, gn_, un_ = reduced(d + t * p, u)
            if np.isfinite(fn_) and fn_ <= f + 1e-4 * t * float(np.dot(g, p)):
                ok = True
                break
            t *= 0.5
        if not ok:
            reason = TaoR.DIVERGED_LS_FAILURE
            break
        S.append(t * p)
        Y.append(gn_ - g)
        if len(S) > 8:
            S.pop(0)
            Y.pop(0)
        d, f, g, u = d + t * p, fn_, gn_, un_
        gnorm = float(np.linalg.norm(g))
        it += 1
        tao._monitor(it, f, gnorm)
    else:
        reason = TaoR.DIVERGED_MAXITS
    if reason == TaoR.CONTINUE_ITERATING:
        reason = TaoR.CONVERGED_GATOL
    _done(tao, xvec, np.concatenate([d, _host(u)]), it, f, gnorm, reason)


def solve_bmrm(tao: Tao, x, xvec):
    """Bundle method for regularised risk minimisation (unconstrained/
    impls/bmrm): J(w) = lambda/2 ||w||^2 + R(w); the cutting planes
    accumulate and each master problem, the small dual QP over the
    simplex, is solved on the host by projected gradient."""
    lam = float(getattr(tao, "bmrm_lambda", 1.0))
    Rg = torch.func.grad_and_value(tao._obj)
    G, bvec = [], []
    wk = np.zeros(x.numel())       # bmrm starts from w = 0
    it = 0
    reason = TaoR.CONTINUE_ITERATING
    Jbest = np.inf
    while it < tao.max_it:
        g, R = Rg(V.as_tensor(wk, like=x))
        R, g = float(R), _host(g)
        J = 0.5 * lam * float(np.dot(wk, wk)) + R
        Jbest = min(Jbest, J)
        G.append(g)
        bvec.append(R - float(np.dot(g, wk)))
        Gm = np.stack(G)
        bm = np.asarray(bvec)
        Q = (Gm @ Gm.T) / lam
        k = len(bvec)
        a = np.full(k, 1.0 / k)
        for _ in range(300):
            grad = Q @ a - bm
            step = 1.0 / (np.linalg.norm(Q, 2) + 1e-12)
            a_new = _project_simplex(a - step * grad)
            if np.linalg.norm(a_new - a) < 1e-12:
                a = a_new
                break
            a = a_new
        wk = -(Gm.T @ a) / lam
        master = -(0.5 * float(a @ Q @ a) - float(a @ bm))
        gap = Jbest - master
        tao._monitor(it, J, max(gap, 0.0))
        if gap <= max(tao.gatol, tao.grtol * abs(Jbest)):
            reason = TaoR.CONVERGED_GATOL
            break
        it += 1
    else:
        reason = TaoR.DIVERGED_MAXITS
    if reason == TaoR.CONTINUE_ITERATING:
        reason = TaoR.CONVERGED_GATOL
    _done(tao, xvec, wk, it, Jbest, 0.0, reason)


def _project_simplex(v):
    """Euclidean projection onto {a >= 0, sum a = 1} (sorting method)."""
    u = np.sort(v)[::-1]
    css = np.cumsum(u) - 1.0
    rho = np.nonzero(u * np.arange(1, len(v) + 1) > css)[0][-1]
    return np.maximum(v - css[rho] / (rho + 1.0), 0.0)


def solve_pounders(tao: Tao, x, xvec):
    """Model-based derivative-free least squares (leastsquares/impls/
    pounders): an interpolation set of evaluated points, a linear model of
    each residual component fitted by least squares, Gauss-Newton trust
    region steps on the model Jacobian (the model work on the host, each
    residual one device evaluation)."""
    if tao._residual is None:
        raise Error("pounders: call setResidual first")
    rfun = tao._residual

    def rf(z):
        return _host(V.flat(rfun(V.as_tensor(z, like=x)))).astype(np.float64)

    xh = _host(x).astype(np.float64)
    n = len(xh)
    delta = 0.1 * max(1.0, float(np.linalg.norm(xh)))
    pts = [xh.copy()]
    R = [rf(xh)]
    for i in range(n):                       # seed: coordinate simplex
        p = xh.copy()
        p[i] += delta
        pts.append(p)
        R.append(rf(p))
    k = int(np.argmin([0.5 * float(np.dot(r, r)) for r in R]))
    xk, rk = pts[k].copy(), R[k].copy()
    fk = 0.5 * float(np.dot(rk, rk))
    tao._monitor(0, fk, 0.0)
    it = 0
    reason = TaoR.CONTINUE_ITERATING
    maxpts = 2 * n + 1
    g = np.zeros(n)
    while it < tao.max_it:
        X = np.asarray(pts) - xk
        Fd = np.asarray(R) - rk
        Jt, *_ = np.linalg.lstsq(X, Fd, rcond=None)
        J = Jt.T
        g = J.T @ rk
        gnorm = float(np.linalg.norm(g))
        if gnorm <= tao.gatol:
            reason = TaoR.CONVERGED_GATOL
            break
        Jd = V.as_tensor(J, like=x).reshape(J.shape)
        d = _host(_steihaug(lambda v: V.flat(Jd.t() @ (Jd @ v)), V.as_tensor(-g, like=x),
                            delta, tol=1e-10 * gnorm))
        if float(np.linalg.norm(d)) == 0:
            reason = TaoR.CONVERGED_STEPTOL
            break
        xn = xk + d
        rn = rf(xn)
        fn = 0.5 * float(np.dot(rn, rn))
        pred = fk - 0.5 * float(np.dot(rk + J @ d, rk + J @ d))
        rho = (fk - fn) / pred if pred > 0 else -1.0
        pts.append(xn)
        R.append(rn)
        if len(pts) > maxpts:                # drop the farthest from the centre
            drop = int(np.argmax([float(np.linalg.norm(p - xk)) for p in pts]))
            pts.pop(drop)
            R.pop(drop)
        if rho > 1e-4 and np.isfinite(fn) and fn < fk:
            xk, rk, fk = xn, rn, fn
            it += 1
            tao._monitor(it, fk, gnorm)
            if rho > 0.75:
                delta = min(2.0 * delta, 1e6)
        else:
            delta *= 0.5
            if delta < 1e-14:
                reason = TaoR.CONVERGED_STEPTOL
                break
    else:
        reason = TaoR.DIVERGED_MAXITS if reason == TaoR.CONTINUE_ITERATING else reason
    if reason == TaoR.CONTINUE_ITERATING:
        reason = TaoR.CONVERGED_GATOL if float(np.linalg.norm(g)) <= max(tao.gatol, 1e-6) \
            else TaoR.CONVERGED_STEPTOL
    _done(tao, xvec, xk, it, fk, 0.0, reason)


Tao._impls.update({
    "lmvm": solve_lmvm,
    "blmvm": solve_blmvm,
    "nls": solve_nls,
    "ntr": solve_ntr,
    "ntl": solve_ntl,
    "pounders": solve_pounders,
    "ssils": solve_ssils,
    "ssfls": solve_ssils,
    "asils": solve_ssils,
    "asfls": solve_ssils,
    "ipm": solve_pdipm,
    "bmrm": solve_bmrm,
    "lcl": solve_lcl,
    "pdipm": solve_pdipm,
    "bnls": solve_nls,
    "cg": solve_cg,
    "brgn": solve_brgn,
    "nm": solve_neldermead,
    "almm": solve_almm,
    "neldermead": solve_neldermead,
})
