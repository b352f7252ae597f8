"""SNES: nonlinear solvers.

Counterpart of ``petsc_tpu/snes/snes.py`` (reference
src/snes/interface/snes.c: SNESSolve :4875, SNESConvergedDefault, FD
Jacobians snesj.c / snesj2.c with colouring, Eisenstat-Walker forcing
snesut.c; impls newtonls ls.c:125, newtontr, ksponly, nrichardson, qn,
anderson/ngmres).

The outer Newton loop is host-driven, one KSP solve per iteration, as in
PETSc. The iterate, the residual and the direction stay tensors on the
Vec's device; the loop brings only the scalars it tests to the host (K4
norms, one read each) and forms trial points on K2. Residual callbacks are
PETSc-style fn(snes, X, F) on Vecs, or a pure torch function fn(x) (or
fn(x, *args)) whose Jacobian action is exact (the MATMFFD replacement,
linearised by reverse mode once a Newton step: ``ops/autodiff.py``),
assembled through ``torch.func.jacfwd`` (dense)
or by finite differences compressed by a colouring (MatFDColoring's greedy
colouring; the differences evaluated on the device).
"""

from __future__ import annotations

import inspect
import math
import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import config
from ..mat.aij import MatAIJ
from ..mat.mat import MatShell
from ..ops import vecops as V
from ..ops.autodiff import Linearization
from ..sys.error import Error, SNESConvergedReason as SR
from ..sys.object import PObject
from ..vec.vec import Vec
from .linesearch import LineSearch


def snes_reason_string(r):
    return SR(r).name


def _as_arg(a):
    """A residual parameter: arrays become tensors on the package's device,
    Python and 0-d numpy scalars stay floats."""
    if isinstance(a, torch.Tensor):
        return a
    if isinstance(a, (int, float)) or (isinstance(a, np.ndarray) and a.ndim == 0) \
            or isinstance(a, np.generic):
        return float(a)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=config.real_dtype(),
                           device=config.device())


class SNES(PObject):
    _class_name = "SNES"
    _impls = {}

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self._type = "newtonls"
        self.rtol, self.abstol, self.stol = 1e-8, 1e-50, 1e-8
        self.divtol = 1e4
        self.max_it, self.max_funcs = 50, 10000
        self.ksp = None
        self.linesearch = LineSearch(self)
        self._func = None           # PETSc-style fn(snes, X, F)
        self._func_pure = None      # pure fn(x, *args) -> r
        self._func_args = ()
        self._fvec = None
        self._jac = None            # PETSc-style fn(snes, X, J, P)
        self._jac_mat = None
        self._jac_pmat = None
        self._jac_mode = None       # user | fd | fd_color | jvp | jacfwd
        self._fd_coloring = None
        self._mf_shell = None
        self.use_ew = False
        self._ew_eta = 0.1
        self._its = 0
        self._fnorm = 0.0
        self._reason = SR.ITERATING
        self._history = []
        self._monitors = []
        self._nfuncs = 0
        self._ksp_its = []          # inner KSP iterations of each Newton step
        self._ls_its = []           # line-search residual evaluations of each step
        self.npc = None
        self.dm = None

    # ---------------- lifecycle ----------------

    def create(self, comm=None):
        self.comm = comm or self.comm
        return self

    def setType(self, t):
        if t not in self._impls:
            raise KeyError(f"unknown SNES type '{t}'; have "
                           f"{sorted(self._impls)}")
        self._type = t
        return self

    def getType(self):
        return self._type

    def setDM(self, dm):
        self.dm = dm
        return self

    def getDM(self):
        return self.dm

    def setTolerances(self, rtol=None, atol=None, stol=None, max_it=None,
                      divtol=None):
        if rtol is not None:
            self.rtol = rtol
        if atol is not None:
            self.abstol = atol
        if stol is not None:
            self.stol = stol
        if max_it is not None:
            self.max_it = max_it
        if divtol is not None:
            self.divtol = divtol
        return self

    def getKSP(self):
        if self.ksp is None:
            from ..ksp.ksp import KSP
            self.ksp = KSP(options=self._options, prefix=self._prefix)
            self.ksp.create(self.comm)
        return self.ksp

    def setFromOptions(self):
        t = self.opt("get_string", "snes_type", None)
        if t:
            self.setType(t)
        for name, attr in (("snes_rtol", "rtol"), ("snes_atol", "abstol"),
                           ("snes_stol", "stol"), ("snes_divergence_tolerance",
                                                   "divtol")):
            v = self.opt("get_real", name, None)
            if v is not None:
                setattr(self, attr, v)
        n = self.opt("get_int", "snes_max_it", None)
        if n:
            self.max_it = n
        if self.opt("get_bool", "snes_ksp_ew", False):
            self.use_ew = True
        v = self.opt("get_int", "snes_lag_jacobian", None)
        if v is not None:
            self.lag_jacobian = v
        v = self.opt("get_int", "snes_lag_preconditioner", None)
        if v is not None:
            self.lag_preconditioner = v
        if self.opt("get_bool", "snes_mf", False):
            self._jac_mode = "jvp"
        if self.opt("get_bool", "snes_fd", False):
            self._jac_mode = "fd"
        if self.opt("get_bool", "snes_fd_color", False):
            self._jac_mode = "fd_color"
        self.linesearch.set_from_options()
        return self

    # ---------------- callbacks ----------------

    def setFunction(self, fn, f=None, args=None):
        """PETSc-style fn(snes, X, F) filling Vec F, or a pure torch
        fn(x, *args) -> r on tensors (exact JVP Jacobians). `args` are the
        residual's parameters (t, dt, u_prev of a TS stage): a new args
        keeps the residual and its matrix-free shell. A pure residual is
        one of one parameter, or one given with args (snes.py:149)."""
        if args is not None or len(inspect.signature(fn).parameters) == 1:
            if self._func_pure is not fn:
                self._func_pure = fn
                self._mf_shell = None
            self._func_args = tuple(_as_arg(a) for a in (args or ()))
        else:
            self._func = fn
            self._fvec = f
        return self

    def setJacobian(self, fn=None, J=None, P=None):
        if fn is not None:
            self._jac = fn
            self._jac_mode = "user"
        self._jac_mat = J
        self._jac_pmat = P if P is not None else J
        return self

    def setUseMF(self, flag=True):
        self._jac_mode = "jvp" if flag else self._jac_mode

    def setUseFD(self, flag=True, coloring=True):
        self._jac_mode = ("fd_color" if coloring else "fd") if flag \
            else self._jac_mode

    def setMonitor(self, fn):
        self._monitors.append(fn)

    # ---------------- function/jacobian evaluation ----------------

    def _eval_F(self, x):
        """The residual at the tensor x, as a flat tensor on x's device."""
        self._nfuncs += 1
        if self._func_pure is not None:
            return V.flat(self._func_pure(x, *self._func_args))
        X = Vec.from_array(x, comm=self.comm)
        F = self._fvec if self._fvec is not None else X.duplicate()
        self._func(self, X, F)
        return V.flat(F.array)

    def _func_np(self, x_np):
        """The residual at a host array, as numpy (the reference's host
        entry point; the loops use :meth:`_eval_F`)."""
        return self._eval_F(V.as_tensor(x_np)).cpu().numpy()

    def computeFunction(self, X: Vec, F: Vec):
        F.array = self._eval_F(X.array)
        return F

    def _resolve_jac_mode(self):
        if self._jac_mode is not None:
            return self._jac_mode
        if self._jac is not None:
            return "user"
        if self._func_pure is not None:
            return "jvp"
        return "fd"

    def setLagJacobian(self, lag):
        """SNESSetLagJacobian (-snes_lag_jacobian): rebuild the Jacobian
        every `lag` iterations; -2 builds once then freezes, -1 never
        builds, 1 (the default) every iteration."""
        self.lag_jacobian = int(lag)
        return self

    def setLagPreconditioner(self, lag):
        """SNESSetLagPreconditioner (-snes_lag_preconditioner): rebuild the
        preconditioning matrix every `lag` Jacobian rebuilds; the same P
        object keeps PCSetUp's state check from setting up again."""
        self.lag_preconditioner = int(lag)
        return self

    lag_jacobian = 1
    lag_preconditioner = 1
    _jac_calls = 0
    _lag_cache = None

    def computeJacobian(self, x):
        """(J, P) at the iterate x, with the lagging policy of
        SNESComputeJacobian (snes.c)."""
        calls = self._jac_calls
        self._jac_calls = calls + 1
        lj, lp = self.lag_jacobian, self.lag_preconditioner
        if self._lag_cache is not None:
            if lj == -1 or (lj == -2 and calls > 0) \
                    or (lj > 1 and calls % lj != 0):
                return self._lag_cache
        t0 = time.perf_counter()
        J, P = self._compute_jacobian_now(x)
        config.log().log_event("SNESJacobianEval", time.perf_counter() - t0)
        if self._lag_cache is not None and (
                lp == -1 or (lp == -2 and calls > 0)
                or (lp > 1 and calls % lp != 0)):
            P = self._lag_cache[1]      # frozen preconditioner matrix
        self._lag_cache = (J, P)
        return J, P

    def _compute_jacobian_now(self, x):
        mode = self._resolve_jac_mode()
        if mode == "user":
            X = Vec.from_array(x, comm=self.comm)
            if self._jac_mat is None:
                n = x.numel()
                self._jac_mat = MatAIJ(self.comm)
                self._jac_mat.setSizes((n, n))
                self._jac_pmat = self._jac_mat
            self._jac(self, X, self._jac_mat, self._jac_pmat)
            if not self._jac_mat._assembled:
                self._jac_mat.assemble()
            return self._jac_mat, self._jac_pmat or self._jac_mat
        if mode == "jvp":
            if self._func_pure is None:
                P = self._assemble_pmat(x, "fd")
                return P, P
            fn, args = self._func_pure, self._func_args
            # the exact Jacobian action at the iterate (MATMFFD done
            # right): linearised once a Newton step, one backward pass a
            # product (ops/autodiff.py)
            lin = Linearization(lambda z: fn(z, *args), x)
            if self._mf_shell is None:
                # one shell per residual; the linearisation travels in its
                # context
                J = MatShell(self.comm)
                n = x.numel()
                J.setSizes((n, n))
                J.setShellOperations(mult=lambda ctx, v: ctx(v), context=lin)
                self._mf_shell = J
            else:
                self._mf_shell._context = lin
            P = self._assemble_pmat(x)
            return self._mf_shell, P
        if mode in ("fd", "jacfwd", "fd_color"):
            P = self._assemble_pmat(x, mode)
            return P, P
        raise Error(f"SNES: unknown jacobian mode {mode}")

    def _assemble_pmat(self, x, mode=None):
        pattern = None
        if self._jac_pmat is not None and self._jac_pmat.nnz() > 0:
            pattern = self._jac_pmat
        elif self.dm is not None and hasattr(self.dm, "preallocateStencilPattern"):
            # DMDA stencil preallocation -> coloured FD Jacobian, the
            # SNESSetDM + SNESComputeJacobianDefaultColor workflow
            self._jac_pmat = self.dm.createMatrix(preallocate_pattern=True)
            pattern = self._jac_pmat
        if mode is None:
            mode = "fd_color" if pattern is not None else (
                "jacfwd" if self._func_pure is not None else "fd")
        if mode == "jacfwd" or (mode == "fd" and self._func_pure is not None):
            fn, args = self._func_pure, self._func_args
            dense = torch.func.jacfwd(lambda z: V.flat(fn(z, *args)))(x)
            return MatAIJ.from_scipy(sp.csr_matrix(dense.detach().cpu().numpy()),
                                     comm=self.comm)
        if mode == "fd":
            return self._fd_dense(x)
        if mode == "fd_color":
            if pattern is None:
                raise Error("SNES fd_color: provide a preallocated pmat "
                            "pattern via setJacobian(J=..., P=...)")
            return self._fd_colored(x, pattern)
        raise Error(f"unknown pmat mode {mode}")

    def _fd_dense(self, x):
        """SNESComputeJacobianDefault (snesj.c): dense forward differences,
        one residual per column."""
        n = x.numel()
        f0 = self._eval_F(x)
        eps = math.sqrt(np.finfo(float).eps)
        xh = x.detach().cpu().numpy()
        cols = []
        for j in range(n):
            h = eps * max(abs(float(xh[j])), 1.0)
            xp = x.clone()
            xp[j] += h
            cols.append((self._eval_F(xp) - f0) / h)
        J = torch.stack(cols, dim=1).cpu().numpy()
        return MatAIJ.from_scipy(sp.csr_matrix(J), comm=self.comm)

    def _fd_colored(self, x, pattern: MatAIJ):
        """SNESComputeJacobianDefaultColor (snesj2.c + MatFDColoring): one
        residual evaluation per colour of the greedy distance-2 colouring
        (MatFDColoring's), the differences scattered into the pattern's
        values on the device. The pattern, its colouring and the returned
        Mat's COO plan are made once per pattern; each call replaces the
        values (setValuesCOO)."""
        st = self._fd_coloring
        if st is None or st["pattern"] is not pattern:
            st = self._fd_coloring = self._fd_plan(pattern, x.device)
        f0 = self._eval_F(x)
        eps = math.sqrt(np.finfo(float).eps)
        h = eps * torch.clamp(x.abs(), min=1.0)
        vals = torch.zeros(st["nnz"], dtype=x.dtype, device=x.device)
        for mask, ent, rows, cols in st["colors"]:
            df = self._eval_F(x + h * mask) - f0
            vals[ent] = df[rows] / h[cols]
        st["mat"].setValuesCOO(vals)
        return st["mat"]

    def _fd_plan(self, pattern, dev):
        from ..mat.fdcoloring import MatFDColoring
        t0 = time.perf_counter()
        fdc = MatFDColoring(pattern)
        Sc = fdc._S.tocsc()
        n = Sc.shape[1]
        ent_col = np.repeat(np.arange(n), np.diff(Sc.indptr))
        ent_row = Sc.indices.astype(np.int64)
        M = MatAIJ(self.comm)
        M.setSizes(Sc.shape)
        M.setPreallocationCOO(ent_row, ent_col)
        colors = []
        ecolor = fdc.colors[ent_col]
        for c in range(fdc.ncolors):
            ent = np.nonzero(ecolor == c)[0]
            mask = torch.as_tensor((fdc.colors == c).astype(np.float64),
                                   dtype=config.real_dtype(), device=dev)
            colors.append((mask, torch.as_tensor(ent, device=dev),
                           torch.as_tensor(ent_row[ent], device=dev),
                           torch.as_tensor(ent_col[ent], device=dev)))
        config.log().log_event("SNESFDColorSetUp", time.perf_counter() - t0)
        return {"pattern": pattern, "mat": M, "nnz": len(ent_row), "colors": colors,
                "ncolors": fdc.ncolors}

    # ---------------- convergence ----------------

    def _converged(self, it, xnorm, snorm, fnorm):
        """SNESConvergedDefault (snes/interface/snesut.c)."""
        if np.isnan(fnorm) or np.isinf(fnorm):
            return SR.DIVERGED_FNORM_NAN
        if fnorm < self.abstol:
            return SR.CONVERGED_FNORM_ABS
        if it > 0:
            if fnorm <= self._ttol:
                return SR.CONVERGED_FNORM_RELATIVE
            if snorm < self.stol * xnorm:
                return SR.CONVERGED_SNORM_RELATIVE
            if self.divtol > 0 and fnorm > self.divtol * self._fnorm0:
                return SR.DIVERGED_DTOL
        if self._nfuncs >= self.max_funcs:
            return SR.DIVERGED_FUNCTION_COUNT
        return SR.ITERATING

    def _ew_rtol(self, fnorm, fnorm_old):
        """Eisenstat-Walker forcing, version 2 (snesut.c)."""
        gamma, alpha = 1.0, 0.5 * (1.0 + math.sqrt(5.0))
        eta = gamma * (fnorm / fnorm_old) ** alpha
        safeguard = gamma * self._ew_eta ** alpha
        if safeguard > 0.1:
            eta = max(eta, safeguard)
        eta = min(max(eta, 1e-10), 0.9)
        self._ew_eta = eta
        return eta

    # ---------------- drive ----------------

    def _monitor(self, it, fnorm):
        self._history.append(fnorm)
        if self.opt("get_bool", "snes_monitor", False):
            print(f"{it:3d} SNES Function norm {fnorm:14.12e}")
        if self.opt("get_bool", "snes_monitor_short", False):
            print(f"{it:3d} SNES Function norm {fnorm:g}")
        for m in self._monitors:
            m(self, it, fnorm)

    def _start(self, x):
        """F(x), its norm, the relative tolerance and the monitor of
        iteration 0; returns (F, fnorm, reason)."""
        F = self._eval_F(x)
        fnorm = V.norm(F)
        self._fnorm0 = fnorm
        self._ttol = self.rtol * fnorm
        self._monitor(0, fnorm)
        return F, fnorm, self._converged(0, 0.0, 0.0, fnorm)

    def solveCompiled(self, x: Vec, args=None):
        """JFNK in one device loop (snes/compiled.py): matrix-free GMRES
        inner solves on exact JVPs, backtracking. Needs a pure residual;
        `args` its parameters."""
        from .compiled import jfnk_solve
        if self._func_pure is None:
            raise Error("solveCompiled needs a pure residual (setFunction "
                        "with fn(x, *args))")
        a = tuple(_as_arg(v) for v in args) if args is not None else self._func_args
        xx, its, fnorm, done, trials = jfnk_solve(self._func_pure, x.array, a, self.rtol,
                                                  self.abstol, max_it=self.max_it)
        x.array = xx
        self._ls_its = trials
        self._its = int(its)
        self._fnorm = float(fnorm)
        self._reason = SR.CONVERGED_FNORM_RELATIVE if done else SR.DIVERGED_MAX_IT
        return x

    def solve(self, b: Vec | None, x: Vec):
        self.setFromOptions()
        self._history = []
        self._ksp_its = []
        self._ls_its = []
        self._nfuncs = 0
        self._reason = SR.ITERATING
        # lag counters restart per solve unless -snes_lag_jacobian_persists
        if not self.opt("get_bool", "snes_lag_jacobian_persists", False):
            self._jac_calls = 0
            self._lag_cache = None
        impl = self._impls[self._type]
        if b is not None:
            raise Error("SNES: nonzero b not yet supported")
        t0 = time.perf_counter()
        impl(self, V.flat(x.array).clone(), x)
        config.log().log_event("SNESSolve", time.perf_counter() - t0)
        if self.opt("get_bool", "snes_converged_reason", False):
            verb = "converged" if self._reason.converged else "did not converge"
            lab = ("CONVERGED_" + self._reason.name.split("CONVERGED_")[-1]
                   if self._reason.converged else self._reason.name)
            print(f"Nonlinear solve {verb} due to {lab} iterations "
                  f"{self._its}")
        return x

    # ---------------- results ----------------

    def getIterationNumber(self):
        return self._its

    def getFunctionNorm(self):
        return self._fnorm

    def getConvergedReason(self):
        return self._reason

    def getConvergenceHistory(self):
        return np.asarray(self._history)

    def view(self, viewer=None):
        print(f"SNES Object: type: {self._type}")
        print(f"  maximum iterations={self.max_it}, "
              f"maximum function evaluations={self.max_funcs}")
        print(f"  tolerances: relative={self.rtol:g}, absolute={self.abstol:g},"
              f" solution={self.stol:g}")


# =====================================================================
# implementations
# =====================================================================

def _ksp_solve_newton(snes, F, J, P):
    """One linear solve J y = F with the SNES KSP; y on F's device, or
    None when the KSP diverged."""
    ksp = snes.getKSP()
    ksp.setOperators(J, P)
    b = Vec.from_array(F, comm=snes.comm)
    y = b.duplicate()
    ksp.error_if_not_converged = False
    ksp.solve(b, y)
    snes._ksp_its.append(int(ksp.getIterationNumber()))
    if ksp.getConvergedReason().value < 0:
        return None
    return V.flat(y.array)


def _finish(snes, x, xt, it, fnorm, reason):
    snes._its = it
    snes._fnorm = fnorm
    snes._reason = reason
    x.array = xt.reshape(x.array.shape).to(x.array.dtype)


def _end(snes, reason):
    return SR.DIVERGED_MAX_IT if reason == SR.ITERATING else reason


def solve_newtonls(snes: SNES, x, xvec):
    """Newton with line search (ls.c:125)."""
    F, fnorm, reason = snes._start(x)
    it = 0
    fnorm_old = fnorm
    while reason == SR.ITERATING and it < snes.max_it:
        if snes.use_ew and it > 0:
            snes.getKSP().setTolerances(rtol=snes._ew_rtol(fnorm, fnorm_old))
        J, P = snes.computeJacobian(x)
        y = _ksp_solve_newton(snes, F, J, P)
        if y is None:
            reason = SR.DIVERGED_LINEAR_SOLVE
            break
        xn, Fn, gnorm, lam, ok = snes.linesearch.apply(x, y, F, fnorm)
        if not ok and gnorm >= fnorm:
            reason = SR.DIVERGED_LINE_SEARCH
            x = xn
            break
        snorm = lam * V.norm(y)
        fnorm_old = fnorm
        x, F, fnorm = xn, Fn, gnorm
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def solve_ksponly(snes: SNES, x, xvec):
    """One Newton step, no line search (impls/ksponly)."""
    F, fnorm, _ = snes._start(x)
    J, P = snes.computeJacobian(x)
    y = _ksp_solve_newton(snes, F, J, P)
    if y is None:
        _finish(snes, xvec, x, 0, fnorm, SR.DIVERGED_LINEAR_SOLVE)
        return
    _finish(snes, xvec, V.axpy(x, -1.0, y), 1, fnorm, SR.CONVERGED_ITS)


def solve_newtontr(snes: SNES, x, xvec):
    """Newton trust region with a dogleg step (impls/tr/tr.c: rho-based
    radius update, delta0 = 0.2 max(||x||, 1))."""
    from ..ops import operator
    F, fnorm, reason = snes._start(x)
    delta = 0.2 * max(V.norm(x), 1.0)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        J, P = snes.computeJacobian(x)
        yN = _ksp_solve_newton(snes, F, J, P)     # newton: J yN = F
        if yN is None:
            reason = SR.DIVERGED_LINEAR_SOLVE
            break
        Jop = operator.bind(J.meta, J.device_data())
        g = V.flat(Jop.mult_t(F)) if Jop.mult_t else F
        accepted = False
        for _ in range(30):
            nrmN = V.norm(yN)
            if nrmN <= delta:
                step = yN
            else:
                # dogleg between the Cauchy point and the Newton step
                gnorm2 = V.normsq(g)
                Jg = V.flat(Jop.mult(g))
                denom = V.normsq(Jg)
                tau = gnorm2 / denom if denom > 0 else 1.0
                yC = V.axpy(torch.zeros_like(g), tau, g)
                nrmC = V.norm(yC)
                if nrmC >= delta:
                    step = V.axpy(torch.zeros_like(g), delta / nrmC, yC)
                else:
                    d = V.axpy(yN, -1.0, yC)
                    a = V.normsq(d)
                    bq = 2.0 * V.dot(yC, d)
                    c = V.normsq(yC) - delta * delta
                    t = (-bq + math.sqrt(max(bq * bq - 4 * a * c, 0.0))) / (2 * a) \
                        if a > 0 else 0.0
                    step = V.axpy(yC, t, d)
            xn = V.axpy(x, -1.0, step)
            Fn = snes._eval_F(xn)
            gn = V.norm(Fn)
            ared = 0.5 * (fnorm ** 2 - gn ** 2)
            Js = V.flat(Jop.mult(step))
            pred = 0.5 * (fnorm ** 2 - V.norm(V.axpy(F, -1.0, Js)) ** 2)
            rho = ared / pred if pred > 0 else -1.0
            if rho < 0.25:
                delta *= 0.25
            elif rho > 0.75:
                delta = min(2.0 * delta, 1e10)
            if rho > 1e-4:
                accepted = True
                snorm = V.norm(step)
                x, F, fnorm = xn, Fn, gn
                break
            if delta < 1e-30:
                break
        if not accepted:
            reason = SR.DIVERGED_TR_DELTA
            break
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def _with_ls(snes, kind_if_bt):
    """The line search with bt replaced by `kind_if_bt` (the solver's own
    default); returns the kind to restore."""
    ls = snes.linesearch
    old = ls.kind
    if ls.kind == "bt":
        ls.kind = kind_if_bt
    return old


def solve_nrichardson(snes: SNES, x, xvec):
    """Nonlinear Richardson: direction -F with the l2 line search
    (impls/nrichardson)."""
    ls = snes.linesearch
    old_kind = _with_ls(snes, "l2")
    F, fnorm, reason = snes._start(x)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        xn, Fn, gnorm, lam, ok = ls.apply(x, F, F, fnorm)
        snorm = lam * fnorm
        x, F, fnorm = xn, Fn, gnorm
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    ls.kind = old_kind
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def lbfgs_two_loop(S, Y, g):
    """H g by the L-BFGS two-loop recursion over the pairs (S, Y), with
    the Shanno scaling of the newest pair; inner products on K4, updates
    on K2."""
    q = V.flat(g).clone()
    alphas = []
    for s, yv in zip(reversed(S), reversed(Y)):
        rho = 1.0 / V.dot(yv, s)
        a = rho * V.dot(s, q)
        alphas.append((a, rho, s, yv))
        q = V.axpy(q, -a, yv)
    if Y:
        s, yv = S[-1], Y[-1]
        q = V.axpy(torch.zeros_like(q), V.dot(s, yv) / V.normsq(yv), q)
    for a, rho, s, yv in reversed(alphas):
        b_ = rho * V.dot(yv, q)
        q = V.axpy(q, a - b_, s)
    return q


def solve_qn(snes: SNES, x, xvec):
    """L-BFGS quasi-Newton on F (impls/qn/qn.c, LBFGS, m = 10, Shanno
    scaling)."""
    m = 10
    S, Y = [], []
    F, fnorm, reason = snes._start(x)
    it = 0
    ls = snes.linesearch
    old_kind = _with_ls(snes, "l2")
    while reason == SR.ITERATING and it < snes.max_it:
        d = lbfgs_two_loop(S, Y, F)
        xn, Fn, gnorm, lam, ok = ls.apply(x, d, F, fnorm)
        if not ok and gnorm >= fnorm:
            # restart from steepest descent
            S.clear()
            Y.clear()
            xn, Fn, gnorm, lam, ok = ls.apply(x, F, F, fnorm)
            if not ok and gnorm >= fnorm:
                reason = SR.DIVERGED_LINE_SEARCH
                break
        s_new = V.axpy(xn, -1.0, x)
        y_new = V.axpy(Fn, -1.0, F)
        if V.dot(y_new, s_new) > 1e-14:
            S.append(s_new)
            Y.append(y_new)
            if len(S) > m:
                S.pop(0)
                Y.pop(0)
        snorm = V.norm(s_new)
        x, F, fnorm = xn, Fn, gnorm
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    ls.kind = old_kind
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def solve_anderson(snes: SNES, x, xvec):
    """Anderson mixing / NGMRES (impls/ngmres): the least-squares
    combination of the last m residuals, beta = 1 mixing. The small
    least-squares problem is solved on the host (its Gram data one read)."""
    m = 10
    beta = 1.0
    Xh, Fh = [], []
    F, fnorm, reason = snes._start(x)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        Xh.append(x.clone())
        Fh.append(F.clone())
        if len(Xh) > m:
            Xh.pop(0)
            Fh.pop(0)
        k = len(Xh)
        if k == 1:
            xn = V.axpy(x, -beta, F)
        else:
            dF = torch.stack([Fh[i] - Fh[-1] for i in range(k - 1)], dim=1)
            coef, *_ = np.linalg.lstsq(dF.cpu().numpy(), -Fh[-1].cpu().numpy(), rcond=None)
            c = torch.as_tensor(coef, dtype=x.dtype, device=x.device)
            dX = torch.stack([Xh[i] - Xh[-1] for i in range(k - 1)], dim=1)
            xn = Xh[-1] + dX @ c - beta * (Fh[-1] + dF @ c)
        Fn = snes._eval_F(xn)
        gnorm = V.norm(Fn)
        snorm = V.norm(V.axpy(xn, -1.0, x))
        x, F, fnorm = xn, Fn, gnorm
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


SNES._impls.update({
    "newtonls": solve_newtonls,
    "newtontr": solve_newtontr,
    "ksponly": solve_ksponly,
    "ksptransposeonly": solve_ksponly,
    "nrichardson": solve_nrichardson,
    "qn": solve_qn,
    "anderson": solve_anderson,
    "ngmres": solve_anderson,
})
