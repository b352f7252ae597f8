"""KSP: Krylov solver context.

Counterpart of ``petsc_tpu/ksp/ksp.py`` (reference KSP interface,
src/ksp/ksp/interface/itfunc.c — KSPSolve :1104, KSPSetUp :330 — the
options/monitor/convergence surface of iterativ.c, and the DM hooks of
dmksp.c: setDM, setComputeOperators, setComputeRHS,
setComputeInitialGuess, then ``solve()`` with no arguments). The residual history
is recorded in the loop; monitors print it after the solve, with the
same text as PETSc's in-loop monitors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config
from ..ops import operator
from ..ops.esteig import eig_bounds_device
from ..parallel.mesh import reducing
from ..pc.pc import PC, PCSide
from ..sys.error import (Error, KSPConvergedReason as KR, NotConvergedError,
                         ksp_reason_string)
from ..sys.object import PObject
from ..vec.vec import Vec
from . import common
from . import impls_basic as _b
from . import impls_more as _m
from . import impls_tr as _tr
from .bcgs import solve_bcgs, solve_ibcgs
from .cheby import solve_chebyshev
from .common import KSPConfig
from .dgmres import solve_dgmres_host
from .fetidp import solve_fetidp_host
from .gltr import solve_gltr
from .gmres import solve_fgmres, solve_gmres
from .idr import solve_idr
from .impls_r3 import solve_bicg, solve_cgls, solve_qmrcgs
from .lgmres import solve_lgmres
from .tcqmr import solve_tcqmr
from .tsirm import solve_tsirm

# solver registry: name -> {"fn": solve function, "norm": default norm
# type, "extras": maker of solver-specific parameters}
_IMPLS: dict[str, dict] = {}


def register_ksp(name, fn, default_norm=common.PRECONDITIONED, extras=None,
                 supports_right=False, host_driven=False):
    """`host_driven`: fn(ksp, A, B, b, x0) -> (x, its, rnorm, reason,
    history, rnorm0), the loop's control on the host (dgmres)."""
    _IMPLS[name] = {"fn": fn, "norm": default_norm, "extras": extras,
                    "right": supports_right, "host_driven": host_driven}


class KSP(PObject):
    _class_name = "KSP"

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self.mat = None
        self.pmat = None
        self.pc: PC | None = None
        self._type = None
        self.rtol, self.abstol, self.divtol, self.max_it = 1e-5, 1e-50, 1e4, 10000
        self.normtype = None          # None -> solver default
        self.guess_nonzero = False
        self.converged_maxits = False
        self.error_if_not_converged = False
        self._its = 0
        self._rnorm = 0.0
        self._rnorm0 = 0.0
        self._reason = KR.ITERATING
        self._history = np.zeros(0)
        self._params = {}             # solver-specific (richardson scale)
        self._monitors = []

    # ---------------- lifecycle ----------------

    def create(self, comm=None):
        self.comm = comm or self.comm
        return self

    def setOperators(self, A, P=None):
        self.mat = A
        self.pmat = P if P is not None else A
        if self.comm is None:
            self.comm = A.comm
        self.getPC().setOperators(self.mat, self.pmat)
        return self

    # ---------------- DM integration (dmksp.c) ----------------

    def setDM(self, dm):
        self.dm = dm
        return self

    def getDM(self):
        return getattr(self, "dm", None)

    def setComputeOperators(self, fn):
        """KSPSetComputeOperators (itfunc.c:3054): fn(ksp, A, B) assembles
        the operator into the DM-created matrix A."""
        self.getDM().setKSPComputeOperators(fn)
        return self

    def setComputeRHS(self, fn):
        self.getDM().setKSPComputeRHS(fn)
        return self

    def setComputeInitialGuess(self, fn):
        """KSPSetComputeInitialGuess: fn(ksp, x) fills the starting vector
        when solve() builds it from the DM."""
        self.getDM()._compute_initial_guess = fn
        return self

    def _assemble_from_dm(self):
        """The operator from the DM's callback into dm.createMatrix(); its
        host seconds are logged as the event KSPComputeOperators."""
        t0 = time.perf_counter()
        dm = self.getDM()
        A = dm.createMatrix()
        dm._compute_operators(self, A, A)
        if not A._assembled:
            A.assemble()
        config.log().log_event("KSPComputeOperators", time.perf_counter() - t0)
        self.setOperators(A)

    def getOperators(self):
        return self.mat, self.pmat

    def getPC(self) -> PC:
        if self.pc is None:
            self.pc = PC(options=self._options, prefix=self._prefix)
            if self.mat is not None:
                self.pc.setOperators(self.mat, self.pmat)
        return self.pc

    def setPC(self, pc):
        self.pc = pc

    def setType(self, name):
        if name not in _IMPLS:
            raise Error(f"KSP type '{name}' is not ported to petsc_tpu_torch "
                        f"(ported: {', '.join(sorted(_IMPLS))}); see ROADMAP.md "
                        "queue 1")
        self._type = name
        return self

    def getType(self):
        return self._type

    def setTolerances(self, rtol=None, atol=None, divtol=None, max_it=None):
        if rtol is not None:
            self.rtol = float(rtol)
        if atol is not None:
            self.abstol = float(atol)
        if divtol is not None:
            self.divtol = float(divtol)
        if max_it is not None:
            self.max_it = int(max_it)
        return self

    def getTolerances(self):
        return self.rtol, self.abstol, self.divtol, self.max_it

    def setNormType(self, nt):
        self.normtype = nt

    def setPCSide(self, side):
        """KSPSetPCSide: "right" turns gmres into fgmres at set-up."""
        self.getPC().side = side

    def setInitialGuessNonzero(self, flag=True):
        self.guess_nonzero = bool(flag)

    def setParam(self, key, value):
        """A solver-specific parameter (restart, richardson scale, ...)."""
        self._params[key] = value
        return self

    def setGMRESRestart(self, r):
        return self.setParam("restart", int(r))

    def setRadius(self, delta):
        """KSPCGSetRadius: the trust-region bound of stcg, nash, qcg, gltr."""
        return self.setParam("radius", float(delta))

    def setMixedPrecision(self, flag=True, inner_rtol=1e-6, max_outer=30):
        """An f32 inner solve of this type inside an f64 outer iterative
        refinement (ksp/ir.py); -ksp_mixed_precision sets the defaults."""
        self._mixed = (bool(flag), float(inner_rtol), int(max_outer))
        return self

    def setGuessType(self, kind="fischer", size=10):
        """Attach a KSPGuess (Fischer or POD, ksp/guess.py) that predicts x0
        from the earlier solves with this operator."""
        from .guess import KSPGuess
        self._guess = KSPGuess(self, kind, size)
        return self._guess

    def setErrorIfNotConverged(self, flag=True):
        self.error_if_not_converged = bool(flag)

    def setMonitor(self, fn):
        self._monitors.append(fn)

    def setFromOptions(self):
        o = self.opt
        t = o("get_string", "ksp_type", None)
        if t:
            self.setType(t)
        if self._type is None:
            self.setType("gmres")      # PETSc's default type
        self.rtol = o("get_real", "ksp_rtol", self.rtol)
        self.abstol = o("get_real", "ksp_atol", self.abstol)
        self.divtol = o("get_real", "ksp_divtol", self.divtol)
        self.max_it = o("get_int", "ksp_max_it", self.max_it)
        nt = o("get_string", "ksp_norm_type", None)
        if nt:
            self.normtype = nt
        if o("get_bool", "ksp_initial_guess_nonzero", False):
            self.guess_nonzero = True
        if o("get_bool", "ksp_converged_maxits", False):
            self.converged_maxits = True
        if o("get_bool", "ksp_error_if_not_converged", False):
            self.error_if_not_converged = True
        r = o("get_int", "ksp_gmres_restart", None)
        if r:
            self._params["restart"] = r
        s = o("get_real", "ksp_richardson_scale", None)
        if s:
            self._params["scale"] = s
        side = o("get_string", "ksp_pc_side", None)
        if side:
            self.getPC().side = side
        self.getPC().setFromOptions()
        return self

    def setUp(self):
        if self._type is None:
            self.setFromOptions()
        # -ksp_pc_side right with gmres: the flexible (right-preconditioned)
        # implementation, the same iterates as right-preconditioned GMRES
        # for a fixed preconditioner (KSPSetPCSide)
        if self.getPC().side == PCSide.RIGHT and self._type == "gmres":
            self._type = "fgmres"
        if self.normtype is None:
            self.normtype = _IMPLS[self._type]["norm"]
        self.getPC().setUp()
        self._setup_called = True
        return self

    # ---------------- solve ----------------

    def _static_cfg(self) -> KSPConfig:
        make_extra = _IMPLS[self._type]["extras"]
        return KSPConfig(max_it=self.max_it, normtype=self.normtype,
                         guess_nonzero=self.guess_nonzero,
                         converged_maxits=self.converged_maxits,
                         extra=make_extra(self) if make_extra is not None else ())

    def solve(self, b: Vec | None = None, x: Vec | None = None):
        """KSPSolve (itfunc.c:1104): set up, run the solver loop, record
        history and reason, run monitors and option-driven reporting. With
        a DM attached and b or x omitted, its callbacks build them
        (ksp.py:316-333): the operator first, then b, then x from the
        initial-guess callback, which makes the guess nonzero."""
        dm = self.getDM()
        if self.mat is None and dm is not None:
            self._assemble_from_dm()
        if b is None and dm is not None:
            b = dm.createGlobalVector()
            dm._compute_rhs(self, b)
        if x is None:
            x = self.mat.createVecRight()
            ig = getattr(dm, "_compute_initial_guess", None) if dm is not None else None
            if ig is not None:
                ig(self, x)
                self.guess_nonzero = True
        self._solution = x
        self.setUp()
        guess = getattr(self, "_guess", None)
        saved_nonzero = self.guess_nonzero
        if guess is not None and not self.guess_nonzero:
            g = guess.formGuess(b.array)
            if g is not None:
                x.array = g
                self.guess_nonzero = True
        cfg = self._static_cfg()
        mixed = getattr(self, "_mixed", None)
        if mixed is None and self.opt("get_bool", "ksp_mixed_precision", False):
            mixed = self._mixed = (True, 1e-6, 30)
        A = operator.bind(self.mat.meta, self.mat.device_data())
        B = operator.bind(self.pc.meta, self.pc.device_data())
        x0 = x.array if self.guess_nonzero else torch.zeros_like(b.array)
        t0 = time.perf_counter()
        # on a distributed operator every inner product of the loop sums over
        # the ranks (parallel/mesh.py reducing)
        with reducing(self.mat.comm):
            res = self._run(A, B, b, x0, cfg, mixed)
        if res.x.is_cuda:
            torch.cuda.synchronize(res.x.device)
        # the KSPSolve time is taken before anything is fetched after the
        # solve, and before the guess's update
        dt = time.perf_counter() - t0
        self.guess_nonzero = saved_nonzero
        x.array = res.x
        self._its = int(res.its)
        self._pass_its = res.pass_its      # per refinement pass, under setMixedPrecision
        self._rnorm = float(res.rnorm)
        self._rnorm0 = float(res.rnorm0)
        self._reason = KR(int(res.reason))
        hist = res.history
        self._history = hist[~np.isnan(hist)]
        if guess is not None and int(self._reason) > 0:
            guess.update(res.x, b.array)
        nnz = self.mat.nnz() if hasattr(self.mat, "nnz") else 0
        config.log().log_event("KSPSolve", dt,
                               flops=2.0 * nnz * max(self._its, 1))
        self._report()
        if self.error_if_not_converged and self._reason.diverged:
            raise NotConvergedError(
                f"KSPSolve has not converged, reason "
                f"{ksp_reason_string(self._reason)}")
        return x

    def _run(self, A, B, b, x0, cfg, mixed):
        """The solver loop on the bound operator and PC."""
        impl = _IMPLS[self._type]
        if impl["host_driven"]:
            xr, its, rnorm, reason, hist, rnorm0 = impl["fn"](self, A, B, b.array, x0)
            res = common.SolveResult(xr, its, rnorm, reason, np.asarray(hist), rnorm0)
        elif mixed and mixed[0]:
            res = self._solve_ir(cfg, mixed, A, b.array, x0)
        elif hasattr(self.pc._impl, "presolve"):
            # PCPreSolve/PCPostSolve (the Eisenstat trick): iterate on the
            # transformed operator, recover x afterwards
            pci = self.pc._impl
            At = operator.bind(*pci.operator_meta_data())
            res = impl["fn"](At, B, pci.presolve(b.array), x0, self.rtol, self.abstol,
                             self.divtol, cfg)
            res = res._replace(x=pci.postsolve(res.x))
        else:
            res = impl["fn"](A, B, b.array, x0, self.rtol, self.abstol, self.divtol, cfg)
        return res

    def _solve_ir(self, cfg, mixed, A64, b, x0):
        """The mixed-precision refinement (ksp/ir.py): the operator and the PC
        bound again on float32 copies of their device data, kept while
        neither changes."""
        from .ir import solve_ir, to_f32
        _, inner_rtol, max_outer = mixed
        key = (id(self.mat.device_data()), getattr(self.mat, "state", None),
               id(self.pc.device_data()))
        cached = getattr(self, "_ir_ops", None)
        if cached is None or cached[0] != key:
            cached = self._ir_ops = (
                key, operator.bind(self.mat.meta, to_f32(self.mat.device_data())),
                operator.bind(self.pc.meta, to_f32(self.pc.device_data())))
        inner_cfg = KSPConfig(max_it=min(cfg.max_it, 1000), normtype=cfg.normtype,
                              converged_maxits=True, extra=cfg.extra)
        outer_cfg = KSPConfig(max_it=max_outer, normtype=cfg.normtype,
                              guess_nonzero=cfg.guess_nonzero,
                              extra=(max_outer, inner_rtol))
        return solve_ir(_IMPLS[self._type]["fn"], inner_cfg, A64, cached[1], cached[2], b,
                        x0, self.rtol, self.abstol, self.divtol, outer_cfg)

    def matSolve(self, B, X=None):
        """KSPMatSolve: solve for each column of B, an (n, k) array (or an
        object with getDenseArray), each from a zero guess and on its own,
        as the reference's vmapped solve does: one solve per column through
        the same solver. The iteration count is the largest over the
        columns and the reason the smallest. Returns X after
        X.setDenseArray: a new MatDense when X is None (ksp.py:482-520),
        else the given X; the (n, k) array when X has no setDenseArray."""
        self.setUp()
        cfg = self._static_cfg()
        fn = _IMPLS[self._type]["fn"]
        A = operator.bind(self.mat.meta, self.mat.device_data())
        Bop = operator.bind(self.pc.meta, self.pc.device_data())
        barr = B.getDenseArray() if hasattr(B, "getDenseArray") else B
        barr = torch.as_tensor(np.asarray(barr), dtype=config.real_dtype()).to(config.device())
        t0 = time.perf_counter()
        cols, its, reasons = [], [], []
        for j in range(barr.shape[1]):
            b = barr[:, j].contiguous()
            res = fn(A, Bop, b, torch.zeros_like(b), self.rtol, self.abstol, self.divtol, cfg)
            cols.append(res.x)
            its.append(int(res.its))
            reasons.append(int(res.reason))
        Xarr = torch.stack(cols, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
        self._its = max(its)
        self._reason = KR(min(reasons))
        nnz = self.mat.nnz() if hasattr(self.mat, "nnz") else 0
        config.log().log_event("KSPMatSolve", dt,
                               flops=2.0 * nnz * max(self._its, 1) * barr.shape[1])
        if X is None:
            from ..mat.mat import MatDense
            X = MatDense(self.comm).setSizes(Xarr.shape)
        if hasattr(X, "setDenseArray"):
            X.setDenseArray(Xarr)
            return X
        return Xarr

    def _report(self):
        o = self.opt
        mon = o("get_bool", "ksp_monitor", False)
        mon_short = o("get_bool", "ksp_monitor_short", False)
        if mon or mon_short:
            for i, r in enumerate(self._history):
                if mon:
                    print(f"{i:3d} KSP Residual norm {r:14.12e}")
                else:
                    print(_short_fmt(i, r))
        for fn in self._monitors:
            for i, r in enumerate(self._history):
                fn(self, i, r)
        if o("get_bool", "ksp_converged_reason", False):
            rs = ksp_reason_string(self._reason)
            if self._reason.converged:
                print(f"Linear solve converged due to {rs} iterations {self._its}")
            else:
                print(f"Linear solve did not converge due to {rs} iterations {self._its}")
        if o("get_bool", "ksp_view", False):
            self.view()
        vs = o("get_string", "ksp_view_solution", None)
        if vs:
            self._view_solution(vs)

    def _view_solution(self, spec):
        """-ksp_view_solution vtk:sol.vtu|sol.vtk|sol.vti (PETSCVIEWERVTK,
        plexvtu.c), binary:path, or a bare path (vtk by its suffix, else
        PETSc binary), as the reference's ksp.py:458-480."""
        kind, _, path = spec.partition(":")
        if not path:
            kind, path = ("vtk", kind) if kind.endswith((".vtu", ".vtk", ".vti")) \
                else ("binary", kind)
        x = self._solution
        if kind == "vtk":
            from ..sys.vtk import write_vtk, write_vtu
            dm = self.getDM() or getattr(self.mat, "_dm", None) \
                or getattr(self.mat, "_grid_shape", None)
            if dm is None:
                raise Error("-ksp_view_solution vtk: needs a DM or grid shape on the operator")
            n = self.mat.getSize()[0]
            w = write_vtk if path.endswith(".vtk") else write_vtu
            w(dm, path, point_data={"solution": x.getArray()[:n]})
        else:
            from ..sys.viewer import vec_save
            vec_save(path, x)

    # ---------------- results ----------------

    def getSolution(self):
        return getattr(self, "_solution", None)

    def getIterationNumber(self):
        return self._its

    def getResidualNorm(self):
        return self._rnorm

    def getConvergedReason(self):
        return self._reason

    def getConvergenceHistory(self):
        return self._history.copy()

    def view(self, viewer=None):
        print(f"KSP Object: ({self._prefix})")
        print(f"  type: {self._type}")
        print(f"  maximum iterations={self.max_it}, "
              f"{'nonzero' if self.guess_nonzero else 'initial guess is zero'}")
        print(f"  tolerances: relative={self.rtol:g}, absolute={self.abstol:g},"
              f" divergence={self.divtol:g}")
        print(f"  {self.normtype.upper()} norm type for convergence test")
        if self.pc is not None:
            self.pc.view()


def _short_fmt(i, r):
    """-ksp_monitor_short format (iterativ.c:286-288)."""
    if r > 1e-9:
        return f"{i:3d} KSP Residual norm {r:g}"
    if r > 1e-11:
        return f"{i:3d} KSP Residual norm {r:5.3e}"
    return f"{i:3d} KSP Residual norm < 1.e-11"


def _rich_extras(ksp):
    return (float(ksp._params.get("scale", 1.0)),)


_REFINE = {"refine_never": 0, "refine_ifneeded": 1, "refine_always": 2}


def _gmres_extras(ksp):
    """(restart, refine): -ksp_gmres_restart (or setGMRESRestart), 30 by
    default; -ksp_gmres_cgs_refinement_type, refine_never by default."""
    restart = int(ksp._params.get("restart", 30))
    ref = ksp.opt("get_string", "ksp_gmres_cgs_refinement_type", None)
    refine = _REFINE.get(ref, int(ksp._params.get("refine", 0)))
    return (restart, refine)


def _cheby_extras(ksp):
    """Chebyshev's bounds: the user's (-ksp_chebyshev_eigenvalues emin,emax)
    or Ritz bounds of D^-1 A through the esteig transform, by default the
    multigrid one (0, 0.1; 0, 1.1) (cheby.c:203)."""
    ev = ksp._params.get("eigenvalues")
    if ev is None:
        s = ksp.opt("get_string", "ksp_chebyshev_eigenvalues", None)
        if s:
            ev = tuple(float(t) for t in s.split(","))
    tform = (0.0, 0.1, 0.0, 1.1)
    s = ksp.opt("get_string", "ksp_chebyshev_esteig", None)
    if s:
        vals = [float(t) for t in s.split(",")]
        tform = tuple(vals + [0.0] * (4 - len(vals)))[:4]
    if ev is None:
        A = ksp.mat
        emin, emax = eig_bounds_device(A.meta, A.device_data(), A.getSize()[0])
        ev = (tform[0] * emin + tform[1] * emax, tform[2] * emin + tform[3] * emax)
    return (float(ev[0]), float(ev[1]))


def _stcg_extras(ksp):
    return (("radius", float(ksp._params.get("radius", 0.0))),)


def _bcgsl_extras(ksp):
    ell = ksp.opt("get_int", "ksp_bcgsl_ell", None) or int(ksp._params.get("ell", 2))
    return (("ell", int(ell)),)


def _idr_extras(ksp):
    s = ksp.opt("get_int", "ksp_idr_s", None) or int(ksp._params.get("s", 4))
    return (("s", int(s)),)


def _lcd_extras(ksp):
    return (("restart", int(ksp._params.get("restart", 30))),)


def _lgmres_extras(ksp):
    restart, refine = _gmres_extras(ksp)
    aug = ksp.opt("get_int", "ksp_lgmres_augment", None)
    if aug is None:
        aug = int(ksp._params.get("aug_dim", 2))
    return (restart, refine, int(aug))


# The names, default norms, extras, right-PC support and host driving of
# the reference's registry (petsc_tpu/ksp/ksp.py:607-821). The aliases are the reference's: the pipelined variants
# (pipecg2, pipecgrr, pipelcg, pipeprcg, groppcg, pipecr, pipefcg,
# pipebcgs, pipegcr, pgmres, pipefgmres) take their base method's
# recurrence; fbcgs and fbcgsr are bcgs (the same iterates for a fixed
# PC); nash and qcg are stcg; agmres is dgmres.
register_ksp("preonly", _b.solve_preonly, default_norm=common.NONE)
register_ksp("none", _b.solve_preonly, default_norm=common.NONE)
register_ksp("richardson", _b.solve_richardson, extras=_rich_extras)
register_ksp("cg", _b.solve_cg)
register_ksp("minres", _b.solve_minres)
register_ksp("gmres", solve_gmres, extras=_gmres_extras)
register_ksp("fgmres", solve_fgmres, default_norm=common.UNPRECONDITIONED,
             extras=_gmres_extras, supports_right=True)
register_ksp("bcgs", solve_bcgs)
register_ksp("chebyshev", solve_chebyshev, extras=_cheby_extras)
register_ksp("cgs", _m.solve_cgs)
register_ksp("tfqmr", _m.solve_tfqmr)
register_ksp("cr", _m.solve_cr)
register_ksp("pipegcr", _m.solve_gcr, default_norm=common.UNPRECONDITIONED,
             supports_right=True)
register_ksp("gcr", _m.solve_gcr, default_norm=common.UNPRECONDITIONED,
             extras=_gmres_extras, supports_right=True)
register_ksp("lsqr", _m.solve_lsqr, default_norm=common.UNPRECONDITIONED)
register_ksp("pipecg", _m.solve_pipecg)
register_ksp("pipecg2", _m.solve_pipecg)
register_ksp("pipecgrr", _m.solve_pipecg)
register_ksp("pipelcg", _m.solve_pipecg)
register_ksp("pipeprcg", _m.solve_pipecg)
register_ksp("symmlq", _m.solve_symmlq)
register_ksp("idr", solve_idr, extras=_idr_extras)
register_ksp("lcd", _tr.solve_lcd, extras=_lcd_extras)
register_ksp("tcqmr", solve_tcqmr)
register_ksp("tsirm", solve_tsirm)
register_ksp("dgmres", solve_dgmres_host, host_driven=True)
register_ksp("agmres", solve_dgmres_host, host_driven=True)
register_ksp("fetidp", solve_fetidp_host, host_driven=True)
register_ksp("stcg", _tr.solve_stcg, extras=_stcg_extras)
register_ksp("nash", _tr.solve_stcg, extras=_stcg_extras)
register_ksp("qcg", _tr.solve_stcg, extras=_stcg_extras)
register_ksp("gltr", solve_gltr, extras=_stcg_extras)
register_ksp("bcgsl", _tr.solve_bcgsl, extras=_bcgsl_extras)
register_ksp("pgmres", solve_gmres, extras=_gmres_extras)
register_ksp("pipefgmres", solve_fgmres, default_norm=common.UNPRECONDITIONED,
             extras=_gmres_extras, supports_right=True)
register_ksp("ibcgs", solve_ibcgs)
register_ksp("fbcgs", solve_bcgs)
register_ksp("fbcgsr", solve_bcgs)
register_ksp("lgmres", solve_lgmres, extras=_lgmres_extras)
register_ksp("cgne", _m.solve_cgne)
register_ksp("fcg", _m.solve_fcg, extras=_gmres_extras)
register_ksp("groppcg", _m.solve_pipecg)
register_ksp("bicg", solve_bicg)
register_ksp("cgls", solve_cgls, default_norm=common.UNPRECONDITIONED)
register_ksp("qmrcgs", solve_qmrcgs)
register_ksp("pipecr", _m.solve_cr)
register_ksp("pipefcg", _m.solve_fcg, extras=_gmres_extras)
register_ksp("pipebcgs", solve_bcgs)
