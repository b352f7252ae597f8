"""TS: ODE/DAE time integrators.

Counterpart of ``petsc_tpu/ts/ts.py`` (reference src/ts/interface/ts.c:
TSSolve :4129 -> TSStep :3563, the RHSFunction G(t, u) / IFunction
F(t, u, udot) split, the exact-final-time modes; impls explicit/euler,
ssp, rk with embedded pairs (rk.c tables), implicit/theta (theta.c:197;
beuler theta = 1, cn the endpoint theta = 0.5), bdf, arkimex, rosw;
adapt/impls basic, dsp and history; tsevent.c; TSTrajectory and
TSAdjointSolve, tssen.c:1563).

Stepping is host-driven. The state is a tensor on the Vec's device; stage
combinations are K2 launches and the controller's norms one host read.
Each implicit stage is a SNES solve whose residual is a pure torch closure
over the user's pure RHS/IFunction, so stage Jacobians are exact JVPs. The
adjoint is reverse mode over the recorded steps, each step checkpointed
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config
from ..ops import vecops as V
from ..sys.error import Error, TSConvergedReason as TR
from ..sys.object import PObject
from ..vec.vec import Vec


# ---------------------------------------------------------------------
# Butcher tables (PETSc impls/explicit/rk/rk.c names)
# ---------------------------------------------------------------------

_RK_TABLES = {
    # name: (A, b, bhat (embedded), order)
    "1fe": ([[0.0]], [1.0], None, 1),
    "2a": ([[0.0, 0.0], [1.0, 0.0]], [0.5, 0.5], [1.0, 0.0], 2),
    "3": ([[0, 0, 0], [2 / 3, 0, 0], [-1 / 3, 1, 0]],
          [0.25, 0.5, 0.25], None, 3),
    "3bs": ([[0, 0, 0, 0], [1 / 2, 0, 0, 0], [0, 3 / 4, 0, 0],
             [2 / 9, 1 / 3, 4 / 9, 0]],
            [2 / 9, 1 / 3, 4 / 9, 0],
            [7 / 24, 1 / 4, 1 / 3, 1 / 8], 3),
    "4": ([[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, 1, 0]],
          [1 / 6, 1 / 3, 1 / 3, 1 / 6], None, 4),
    "5dp": ([[0, 0, 0, 0, 0, 0, 0],
             [1 / 5, 0, 0, 0, 0, 0, 0],
             [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
             [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
             [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
             [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
              -5103 / 18656, 0, 0],
             [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]],
            [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
            [5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
             187 / 2100, 1 / 40], 5),
}

# IMEX additive RK: "a2" (L-stable, 2nd order) and ARS(2,3,3)
_GAMMA_A2 = 1.0 - 1.0 / np.sqrt(2.0)
_ARS = (3 + np.sqrt(3)) / 6
_ARK_TABLES = {
    "a2": {
        "Ae": [[0.0, 0.0], [1.0, 0.0]],
        "be": [0.5, 0.5],
        "Ai": [[0.0, 0.0], [0.5, 0.5]],
        "bi": [0.5, 0.5],
        "order": 2,
    },
    "ars233": {
        "Ae": [[0, 0, 0], [_ARS, 0, 0], [_ARS - 1, 2 * (1 - _ARS), 0]],
        "be": [0.0, 0.5, 0.5],
        "Ai": [[0, 0, 0], [0, _ARS, 0], [0, 1 - 2 * _ARS, _ARS]],
        "bi": [0.0, 0.5, 0.5],
        "order": 3,
    },
}

# Rosenbrock-W: ROS3P (Lang-Verwer, 3rd order, 3 stages)
_ROS3P_GAMMA = 0.5 + np.sqrt(3) / 6


def _host(v):
    """An event indicator's or postevent's value as a 1-D numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(v, dtype=np.float64))


class TS(PObject):
    _class_name = "TS"
    _impls = {}

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self._type = "rk"
        self.rk_type = "3bs"
        self.arkimex_type = "ars233"
        self.theta = 0.5
        self.theta_endpoint = False
        self.bdf_order = 2
        self.t = 0.0
        self.dt = 0.01
        self.max_time = 1.0
        self.max_steps = 10 ** 9
        self.exact_final = "matchstep"   # matchstep | stepover | interpolate
        self._rhs = None                 # pure f(t, u) -> udot
        self._ifunc = None               # pure F(t, u, udot) -> r
        self._steps = 0
        self._rejects = 0
        self._reason = TR.CONVERGED_ITERATING
        self._monitors = []
        self.adapt = TSAdapt(self)
        self.snes = None
        self.dm = None
        self._snes_failures = 0
        self.max_snes_failures = -1
        self._snes_its = 0               # Newton steps of the stage solves
        self._ls_its = []                # and their line searches' residuals
        self._solution = None

    # ---------------- lifecycle ----------------

    def create(self, comm=None):
        self.comm = comm or self.comm
        return self

    def setType(self, t):
        if t not in self._impls:
            raise KeyError(f"unknown TS type '{t}'; have {sorted(self._impls)}")
        self._type = t
        if t == "beuler":
            self._type, self.theta, self.theta_endpoint = "theta", 1.0, False
        if t == "cn":
            self._type, self.theta, self.theta_endpoint = "theta", 0.5, True
        return self

    def getType(self):
        return self._type

    def setRHSSplit(self, name, fn, iset=None):
        """TSRHSSplitSetRHSFunction: the named additive RHS part fn(t, u);
        iset masks its contribution to those components."""
        if not hasattr(self, "_rhs_splits"):
            self._rhs_splits = {}
        self._rhs_splits[name] = (fn, None if iset is None
                                  else np.asarray(iset, dtype=np.int64))
        return self

    def setI2Function(self, fn):
        """TSSetI2Function: pure F(t, u, u', u'') for 2nd-order systems."""
        self._i2func = fn
        return self

    def setRHSFunction(self, fn):
        """Pure torch fn(t, u) -> du/dt (TSSetRHSFunction)."""
        self._rhs = fn
        return self

    def setIFunction(self, fn):
        """Pure torch fn(t, u, udot) -> residual (TSSetIFunction)."""
        self._ifunc = fn
        return self

    def setTime(self, t):
        self.t = float(t)

    def getTime(self):
        return self.t

    def setTimeStep(self, dt):
        self.dt = float(dt)

    def getTimeStep(self):
        return self.dt

    def setMaxTime(self, T):
        self.max_time = float(T)

    def setMaxSteps(self, n):
        self.max_steps = int(n)

    def setExactFinalTime(self, mode):
        self.exact_final = mode

    def setRKType(self, t):
        self.rk_type = t

    def setARKIMEXType(self, t):
        self.arkimex_type = t

    def setTheta(self, th, endpoint=None):
        self.theta = th
        if endpoint is not None:
            self.theta_endpoint = endpoint

    def setBDFOrder(self, k):
        self.bdf_order = int(k)

    def setMonitor(self, fn):
        self._monitors.append(fn)

    # ---------------- events (ts/event/tsevent.c) ----------------

    def setEventHandler(self, indicator, postevent=None, terminate=False):
        """indicator(ts, t, u) -> event function values; an event fires
        where one changes sign across a step, located by bisection
        re-stepping; postevent(ts, t, u) may return a new u; terminate
        stops the solve (TSSetEventHandler)."""
        self._event = (indicator, postevent, terminate)
        return self

    # ---------------- trajectory / adjoints ----------------

    def setSaveTrajectory(self, flag=True):
        """Record (t, dt) of the accepted steps (TSTrajectory memory);
        enables replay, adjointSolve and forwardSensitivities."""
        self._save_traj = bool(flag)
        self._traj = []
        return self

    def getTrajectory(self):
        return list(getattr(self, "_traj", []))

    def trajectorySave(self, path):
        """TSTrajectory 'singlefile': the (t, dt) schedule and the final
        state in one npz file (keys t, dt, u_final, as the reference's)."""
        traj = getattr(self, "_traj", None)
        if traj is None:
            raise Error("trajectorySave: setSaveTrajectory before solve")
        uf = self._solution.detach().cpu().numpy() if self._solution is not None \
            else np.zeros(0)
        np.savez(path, t=np.asarray([t for t, _ in traj]),
                 dt=np.asarray([d for _, d in traj]), u_final=uf)
        return self

    def trajectoryLoad(self, path):
        """Restore a saved (t, dt) schedule, so that replay and
        adjointSolve work in a fresh process (TSTrajectoryGet role)."""
        z = np.load(path)
        self._traj = list(zip(z["t"].tolist(), z["dt"].tolist()))
        self._save_traj = True
        return self

    def _pure_step(self, t, u, dt):
        """One explicit step in plain torch arithmetic, differentiable (the
        replay's step)."""
        if self._type == "euler":
            return u + dt * self._rhs(t, u)
        if self._type == "ssp":
            f = self._rhs
            u1 = u + dt * f(t, u)
            u2 = 0.75 * u + 0.25 * (u1 + dt * f(t + dt, u1))
            return u / 3.0 + 2.0 / 3.0 * (u2 + dt * f(t + 0.5 * dt, u2))
        if self._type == "rk":
            A, b, bhat, order = _RK_TABLES[self.rk_type]
            c = [float(sum(row)) for row in A]
            ks = []
            for i in range(len(b)):
                ui = u
                for j in range(i):
                    if A[i][j] != 0.0:
                        ui = ui + (dt * A[i][j]) * ks[j]
                ks.append(self._rhs(t + c[i] * dt, ui))
            un = u
            for i in range(len(b)):
                if b[i] != 0.0:
                    un = un + (dt * b[i]) * ks[i]
            return un
        raise Error(f"TS adjoint replay: type {self._type} is not a pure "
                    "explicit step (use euler/ssp/rk)")

    def solveCompiled(self, u0, nsteps=None, dt=None, t0=0.0):
        """Fixed-step integration of the explicit types (euler, ssp, rk) in
        one loop with no host read, differentiable end to end. Returns
        (u_final, t_final); a Vec u0 is updated in place."""
        dt = self.dt if dt is None else float(dt)
        if nsteps is None:
            nsteps = int(round((self.max_time - t0) / dt))
        u = u0.array if isinstance(u0, Vec) else u0
        if not isinstance(u, torch.Tensor):
            u = V.as_tensor(u)
        t = t0
        for _ in range(nsteps):
            u = self._pure_step(t, u, dt)
            t = t + dt
        self.t = float(t)
        self._steps = nsteps
        self._reason = TR.CONVERGED_TIME
        if isinstance(u0, Vec):
            u0.array = u
            return u0, float(t)
        return u, float(t)

    def replay(self, u0, checkpoint=True):
        """The forward integration over the recorded steps, differentiable;
        each step is rematerialised in the backward pass (checkpointed,
        the Revolve role of TSTrajectory)."""
        traj = getattr(self, "_traj", None)
        if not traj:
            raise Error("TS.replay: call setSaveTrajectory before solve")
        u = u0 if isinstance(u0, torch.Tensor) else V.as_tensor(u0)
        for (t, dt) in traj:
            if checkpoint and u.requires_grad:
                u = torch.utils.checkpoint.checkpoint(
                    self._pure_step, t, u, dt, use_reentrant=False)
            else:
                u = self._pure_step(t, u, dt)
        return u

    def adjointSolve(self, dJdu, u0):
        """lambda_0 = (d u_final / d u_0)^T dJdu by reverse mode over the
        recorded trajectory (TSAdjointSolve, tssen.c:1563)."""
        u = V.as_tensor(u0.array if isinstance(u0, Vec) else u0).detach().requires_grad_(True)
        g = V.as_tensor(dJdu.array if isinstance(dJdu, Vec) else dJdu, like=u)
        with torch.enable_grad():
            uT = self.replay(u)
            lam, = torch.autograd.grad(uT, u, grad_outputs=g)
        return Vec.from_array(lam.detach(), comm=self.comm)

    def forwardSensitivities(self, u0, Vs):
        """S_final = (d u_final / d u_0) V by forward mode
        (TSForwardSetSensitivities). V: (n,) or an (n, k) seed matrix;
        returns numpy."""
        u = V.as_tensor(u0.array if isinstance(u0, Vec) else u0)
        S = torch.as_tensor(np.asarray(Vs, dtype=np.float64), dtype=u.dtype,
                            device=u.device)

        def rep(z):
            return self.replay(z, checkpoint=False)

        if S.dim() == 1:
            return torch.func.jvp(rep, (u,), (S,))[1].detach().cpu().numpy()
        cols = [torch.func.jvp(rep, (u,), (S[:, i].contiguous(),))[1]
                for i in range(S.shape[1])]
        return torch.stack(cols, dim=1).detach().cpu().numpy()

    def getSNES(self):
        if self.snes is None:
            from ..snes.snes import SNES
            self.snes = SNES(options=self._options, prefix=self._prefix)
            self.snes.create(self.comm)
            if self.dm is not None:
                # TSGetSNES attaches the TS DM (ts.c): stage Jacobians then
                # assemble by coloured FD on the DMDA's stencil pattern
                self.snes.setDM(self.dm)
        return self.snes

    def setDM(self, dm):
        """TSSetDM: the grid manager of the stage solves."""
        self.dm = dm
        if self.snes is not None:
            self.snes.setDM(dm)
        return self

    def setFromOptions(self):
        t = self.opt("get_string", "ts_type", None)
        if t:
            self.setType(t)
        for name, attr in (("ts_dt", "dt"), ("ts_max_time", "max_time")):
            v = self.opt("get_real", name, None)
            if v is not None:
                setattr(self, attr, v)
        n = self.opt("get_int", "ts_max_steps", None)
        if n is not None:
            self.max_steps = n
        t = self.opt("get_string", "ts_rk_type", None)
        if t:
            self.rk_type = t
        t = self.opt("get_string", "ts_adapt_type", None)
        if t:
            self.adapt.kind = t
        th = self.opt("get_real", "ts_theta_theta", None)
        if th:
            self.theta = th
        if self.opt("get_bool", "ts_theta_endpoint", False):
            self.theta_endpoint = True
        n = self.opt("get_int", "ts_bdf_order", None)
        if n:
            self.bdf_order = n
        return self

    # ---------------- function evaluation ----------------

    def rhs(self, t, u):
        if self._rhs is not None:
            return self._rhs(t, u)
        if self._ifunc is not None:
            # G(t, u) from F(t, u, udot) = udot - G
            return -self._ifunc(t, u, torch.zeros_like(u))
        raise Error("TS: set a RHSFunction or IFunction")

    def ifunction(self, t, u, udot):
        if self._ifunc is not None:
            return self._ifunc(t, u, udot)
        return udot - self._rhs(t, u)

    # ---------------- drive ----------------

    def _monitor(self, step, t, u):
        if self.opt("get_bool", "ts_monitor", False):
            print(f"{step} TS dt {self.dt:g} time {t:g}")
        for m in self._monitors:
            m(self, step, t, u)

    def solve(self, u: Vec):
        self.setFromOptions()
        impl = self._impls[self._type]
        t0 = time.perf_counter()
        uc = V.flat(u.array).clone()
        self._steps = 0
        self._snes_its = 0
        self._ls_its = []
        self._reason = TR.CONVERGED_ITERATING
        self._monitor(0, self.t, uc)
        while self._reason == TR.CONVERGED_ITERATING:
            if self.t >= self.max_time - 1e-14 * max(1.0, abs(self.max_time)):
                self._reason = TR.CONVERGED_TIME
                break
            if self._steps >= self.max_steps:
                self._reason = TR.CONVERGED_ITS
                break
            dt = self.dt
            if self.exact_final == "matchstep" and self.t + dt > self.max_time:
                dt = self.max_time - self.t
            overshoot = (self.exact_final == "interpolate"
                         and self.t + dt > self.max_time)
            unew, err_est, order, ok = impl(self, self.t, uc, dt)
            if not ok:
                self._snes_failures += 1
                if self.adapt.kind == "none" or self._snes_failures > 20:
                    self._reason = TR.DIVERGED_NONLINEAR_SOLVE
                    break
                self.dt = 0.25 * dt
                continue
            if err_est is not None and self.adapt.kind != "none":
                accept, dt_new = self.adapt.choose(dt, err_est, order, unew)
                self.dt = dt_new
                if not accept:
                    self._rejects += 1
                    if self._rejects > self.adapt.max_rejects:
                        self._reason = TR.DIVERGED_STEP_REJECTED
                        break
                    continue
                self._rejects = 0
            if getattr(self, "_event", None) is not None:
                fired, dt, unew, stop = self._event_step(impl, self.t, uc, dt, unew)
            else:
                stop = False
            if getattr(self, "_save_traj", False):
                self._traj.append((self.t, dt))
            if overshoot:
                # TS_EXACTFINALTIME_INTERPOLATE: step past, interpolate back
                w = (self.max_time - self.t) / dt
                uc = (1 - w) * uc + w * unew
                self.t = self.max_time
                self._steps += 1
                self._monitor(self._steps, self.t, uc)
                self._reason = TR.CONVERGED_TIME
                break
            self.t += dt
            uc = unew
            self._steps += 1
            self._monitor(self._steps, self.t, uc)
            if stop:
                self._reason = TR.CONVERGED_EVENT
                break
        u.array = uc.reshape(u.array.shape).to(u.array.dtype)
        self._solution = uc
        config.log().log_event("TSSolve", time.perf_counter() - t0,
                               count=max(self._steps, 1))
        if self.opt("get_bool", "ts_converged_reason", False):
            print(f"TS solve converged due to {self._reason.name} "
                  f"steps {self._steps}")
        return u

    def _event_step(self, impl, t, u0, dt, unew):
        """Sign change and bisection root location by re-stepping
        (tsevent.c): (fired, dt_used, u_used, terminate)."""
        indicator, postevent, terminate = self._event
        g0 = _host(indicator(self, t, u0))
        g1 = _host(indicator(self, t + dt, unew))
        change = (np.sign(g0) != np.sign(g1)) & (np.sign(g0) != 0)
        if not change.any():
            return False, dt, unew, False
        lo, hi = 0.0, dt
        u_hi = unew
        for _ in range(40):
            if hi - lo < 1e-10 * max(dt, 1e-30):
                break
            mid = 0.5 * (lo + hi)
            u_mid, _, _, ok = impl(self, t, u0, mid)
            g_mid = _host(indicator(self, t + mid, u_mid))
            if ((np.sign(g0) != np.sign(g_mid)) & (np.sign(g0) != 0)).any():
                hi, u_hi = mid, u_mid
            else:
                lo = mid
        if postevent is not None:
            out = postevent(self, t + hi, u_hi)
            if out is not None:
                u_hi = V.as_tensor(out, like=u0)
        return True, hi, u_hi, bool(terminate)

    # ---------------- results ----------------

    def getStepNumber(self):
        return self._steps

    def getSNESIterations(self):
        """TSGetSNESIterations: the Newton steps of every stage solve of
        the last solve."""
        return self._snes_its

    def getConvergedReason(self):
        return self._reason

    def view(self, viewer=None):
        print(f"TS Object: type: {self._type}")
        print(f"  maximum steps={self.max_steps}, maximum time={self.max_time:g}")
        print(f"  current time={self.t:g}, dt={self.dt:g}, "
              f"steps taken={self._steps}")


class TSAdapt:
    """Step controller (src/ts/adapt/impls): basic (accept if wlte <= 1,
    dt by the 1/(order+1) power rule), dsp (Soderlind's H211PI filter),
    history (a prescribed dt sequence), none (fixed step)."""

    def __init__(self, ts, kind="basic"):
        self.ts = ts
        self.kind = kind
        self.rtol, self.atol = 1e-4, 1e-4
        self.safety = 0.9
        self.clip = (0.1, 10.0)
        self.dt_min, self.dt_max = 1e-20, 1e20
        self.max_rejects = 30
        self.dsp_kbeta = (1.0 / 6.0, 1.0 / 6.0, 0.0)
        self.dsp_alpha = (0.0, 0.0)
        self._e_hist = [1.0, 1.0]
        self._rho_hist = [1.0]
        self._history = None
        self._hist_i = 0

    def setHistory(self, dts):
        """TSAdaptHistorySetHistory: a prescribed step sequence."""
        self._history = np.asarray(dts, dtype=np.float64)
        self._hist_i = 0
        self.kind = "history"
        return self

    def _wlte(self, err_vec, u):
        """The weighted RMS of the error estimate (one host read)."""
        w = self.atol + self.rtol * u.abs()
        return float(torch.sqrt(torch.mean((err_vec / w) ** 2)))

    def choose(self, dt, err_vec, order, u):
        if self.kind == "history":
            self._hist_i += 1
            if self._hist_i < len(self._history):
                return True, float(self._history[self._hist_i])
            return True, dt
        wlte = self._wlte(err_vec, u)
        if self.kind == "dsp":
            k = 1.0 / (order + 1)
            e0 = 1.0 / max(wlte, 1e-14)
            e1, e2 = self._e_hist
            b1, b2, b3 = self.dsp_kbeta
            a1, a2 = self.dsp_alpha
            rho = (e0 ** (b1 * k)) * (e1 ** (b2 * k)) * (e2 ** (b3 * k)) \
                * (self._rho_hist[-1] ** (-a1))
            fac = float(np.clip(self.safety * rho, *self.clip))
            accept = wlte <= 1.0
            if accept:
                self._e_hist = [e0, e1]
                self._rho_hist = [rho]
            return accept, float(np.clip(dt * fac, self.dt_min, self.dt_max))
        if wlte > 0:
            fac = self.safety * wlte ** (-1.0 / (order + 1))
        else:
            fac = self.clip[1]
        fac = float(np.clip(fac, self.clip[0], self.clip[1]))
        return wlte <= 1.0, float(np.clip(dt * fac, self.dt_min, self.dt_max))


# =====================================================================
# steppers: each returns (u_new, err_estimate|None, order, ok)
# =====================================================================

def _rhs(ts, t, u):
    return V.flat(ts.rhs(t, u))


def step_euler(ts: TS, t, u, dt):
    un = V.axpy(u, dt, _rhs(ts, t, u))
    return un, None, 1, V.finite(un)


def step_ssp(ts: TS, t, u, dt):
    """Strong-stability-preserving RK (impls/explicit/ssp): rks2
    (SSPRK(s,2), s = 5), rks3 (Shu-Osher SSPRK(3,3)), rk104 (Ketcheson's
    SSPRK(10,4)); ts.ssp_type."""
    kind = getattr(ts, "ssp_type", "rks3")
    f = ts.rhs
    if kind == "rks2":
        s_st = int(getattr(ts, "ssp_nstages", 5))
        v = u
        tt = t
        for _ in range(s_st - 1):
            v = v + dt / (s_st - 1) * f(tt, v)
            tt = tt + dt / (s_st - 1)
        un = ((s_st - 1) * v + u + dt * f(tt, v)) / s_st
        order = 2
    elif kind == "rk104":
        v = u
        tt = t
        for _ in range(5):
            v = v + dt / 6.0 * f(tt, v)
            tt = tt + dt / 6.0
        w = (u + 9.0 * v) / 25.0
        v = 15.0 * w - 5.0 * v
        tt = t + dt / 3.0
        for _ in range(4):
            v = v + dt / 6.0 * f(tt, v)
            tt = tt + dt / 6.0
        un = w + 0.6 * v + 0.1 * dt * f(tt, v)
        order = 4
    else:
        u1 = u + dt * f(t, u)
        u2 = 0.75 * u + 0.25 * (u1 + dt * f(t + dt, u1))
        un = u / 3.0 + 2.0 / 3.0 * (u2 + dt * f(t + 0.5 * dt, u2))
        order = 3
    un = V.flat(un)
    return un, None, order, V.finite(un)


def step_rk(ts: TS, t, u, dt):
    A, b, bhat, order = _RK_TABLES[ts.rk_type]
    s = len(b)
    ks = []
    c = [float(sum(row)) for row in A]
    for i in range(s):
        ui = u
        for j in range(i):
            if A[i][j] != 0.0:
                ui = V.axpy(ui, dt * A[i][j], ks[j])
        ks.append(_rhs(ts, t + c[i] * dt, ui))
    un = u
    for i in range(s):
        if b[i] != 0.0:
            un = V.axpy(un, dt * b[i], ks[i])
    err = None
    if bhat is not None:
        err = V.lincomb([(dt * (b[i] - bhat[i]), ks[i]) for i in range(s)], u)
    return un, err, order, V.finite(un)


def _stage_residual(ts: TS, key, builder):
    """One residual function per (TS, stage kind): the step's values (t,
    dt, earlier states) travel as args, so the matrix-free shell is kept
    across steps."""
    cache = ts.__dict__.setdefault("_stage_residuals", {})
    if key not in cache:
        cache[key] = builder()
    return cache[key]


def _snes_stage_solve(ts: TS, residual, args, u0):
    """Solve residual(u, *args) = 0 with the TS SNES; with
    ts.use_compiled_snes the device-loop JFNK (snes/compiled.py)."""
    snes = ts.getSNES()
    snes.setFunction(residual, args=args)
    x = Vec.from_array(u0, comm=ts.comm)
    if getattr(ts, "use_compiled_snes", False):
        snes.solveCompiled(x, args=args)
    else:
        snes.solve(None, x)
    ts._snes_its += snes.getIterationNumber()
    ts._ls_its += snes._ls_its
    return V.flat(x.array), snes.getConvergedReason().converged


def step_theta(ts: TS, t, u, dt):
    """TSStep_Theta (theta.c:197): F(t + th dt, u_th, (u_th - u)/(th dt))
    = 0, then extrapolation; the endpoint variant (CN) solves at t + dt."""
    th = ts.theta
    if ts.theta_endpoint:
        if ts._ifunc is None:
            def build():
                f = ts._rhs

                def residual(x, tt, dtt, uprev):
                    return (x - uprev) / dtt - (th * f(tt + dtt, x)
                                                + (1 - th) * f(tt, uprev))
                return residual
            residual = _stage_residual(ts, ("theta_ep", th), build)
        else:
            def build():
                F = ts._ifunc

                def residual(x, tt, dtt, uprev):
                    return F(tt + dtt, x, (x - uprev) / dtt)
                return residual
            residual = _stage_residual(ts, ("theta_ep_i", th), build)
        un, ok = _snes_stage_solve(ts, residual, (t, dt, u), u)
        return un, None, 2 if th == 0.5 else 1, ok

    def build():
        F = ts.ifunction

        def residual(x, tt, dtt, uprev):
            return F(tt + th * dtt, x, (x - uprev) / (th * dtt))
        return residual

    residual = _stage_residual(ts, ("theta", th), build)
    ustage, ok = _snes_stage_solve(ts, residual, (t, dt, u), u)
    if not ok:
        return u, None, 1, False
    un = u + (ustage - u) / th
    return un, None, 2 if th == 0.5 else 1, V.finite(un)


_BDF_ALPHA = {
    1: ([1.0, -1.0], 1.0),
    2: ([3 / 2, -2.0, 1 / 2], 1.0),
    3: ([11 / 6, -3.0, 3 / 2, -1 / 3], 1.0),
    4: ([25 / 12, -4.0, 3.0, -4 / 3, 1 / 4], 1.0),
    5: ([137 / 60, -5.0, 5.0, -10 / 3, 5 / 4, -1 / 5], 1.0),
    6: ([147 / 60, -6.0, 15 / 2, -20 / 3, 15 / 4, -6 / 5, 1 / 6], 1.0),
}


def step_bdf(ts: TS, t, u, dt):
    """BDF k (impls/bdf): constant-step coefficients with the order ramped
    up from the history."""
    hist = getattr(ts, "_bdf_hist", None)
    if hist is None or getattr(ts, "_bdf_dt", None) != dt:
        hist = [u.clone()]
        ts._bdf_hist = hist
    k = min(ts.bdf_order, len(hist))
    alphas = _BDF_ALPHA[k][0]

    def build():
        F = ts.ifunction

        def residual(x, tt, dtt, *uhist):
            acc = alphas[0] * x
            for i in range(1, k + 1):
                acc = acc + alphas[i] * uhist[i - 1]
            return F(tt + dtt, x, acc / dtt)
        return residual

    residual = _stage_residual(ts, ("bdf", k), build)
    un, ok = _snes_stage_solve(ts, residual, (t, dt, *hist[:k]), u)
    if not ok:
        return u, None, k, False
    hist.insert(0, un.clone())
    del hist[max(ts.bdf_order + 1, 7):]
    ts._bdf_dt = dt
    return un, None, k, V.finite(un)


def step_arkimex(ts: TS, t, u, dt):
    """Additive IMEX RK (impls/arkimex): the RHSFunction explicit, the
    IFunction's stiff part F(t, u, udot) = udot - f_i implicit."""
    tab = _ARK_TABLES[ts.arkimex_type]
    Ae, be = tab["Ae"], tab["be"]
    Ai, bi = tab["Ai"], tab["bi"]
    s = len(be)
    fe = ts._rhs if ts._rhs is not None else (lambda tt, x: torch.zeros_like(x))
    ce = [float(sum(r)) for r in Ae]
    Ke, Ki = [], []

    def fi(tt, x):
        if ts._ifunc is None:
            return torch.zeros_like(x)
        return -ts._ifunc(tt, x, torch.zeros_like(x))

    for i in range(s):
        base = u
        for j in range(i):
            base = V.axpy(V.axpy(base, dt * Ae[i][j], Ke[j]), dt * Ai[i][j], Ki[j])
        aii = Ai[i][i]
        if aii == 0.0:
            ui = base
        else:
            def build():
                def residual(x, basev, gdt, tstage):
                    return x - basev - gdt * fi(tstage, x)
                return residual
            residual = _stage_residual(ts, ("ark",), build)
            ui, ok = _snes_stage_solve(ts, residual, (base, dt * aii, t + ce[i] * dt), base)
            if not ok:
                return u, None, tab["order"], False
        Ke.append(V.flat(fe(t + ce[i] * dt, ui)))
        Ki.append(V.flat(fi(t + ce[i] * dt, ui)))
    un = u
    for i in range(s):
        un = V.axpy(V.axpy(un, dt * be[i], Ke[i]), dt * bi[i], Ki[i])
    return un, None, tab["order"], V.finite(un)


def step_rosw(ts: TS, t, u, dt):
    """Rosenbrock-W ROS3P (impls/rosw; Lang and Verwer 2001): one dense
    Jacobian (torch.func.jacfwd) and three linear solves, factored and
    solved on the host (scipy), as the reference's."""
    import scipy.linalg as sla
    g = _ROS3P_GAMMA
    a21, a31, a32 = 1.267949192431123, 1.267949192431123, 0.0
    c21, c31, c32 = -1.607695154586736, -3.464101615137755, -1.732050807568877
    m1, m2, m3 = 2.0, 0.5773502691896258, 0.4226497308103742
    n = u.numel()
    J = torch.func.jacfwd(lambda x: V.flat(ts.rhs(t, x)))(u).detach().cpu().numpy()
    try:
        lu = sla.lu_factor(np.eye(n) / (dt * g) - J)
    except Exception:
        return u, None, 3, False

    def solve(rhs):
        return V.as_tensor(sla.lu_solve(lu, rhs.detach().cpu().numpy()), like=u)

    k1 = solve(_rhs(ts, t, u))
    u2 = V.axpy(u, a21, k1)
    k2 = solve(V.axpy(_rhs(ts, t + dt, u2), c21 / dt, k1))
    u3 = V.axpy(V.axpy(u, a31, k1), a32, k2)
    k3 = solve(V.axpy(V.axpy(_rhs(ts, t + dt, u3), c31 / dt, k1), c32 / dt, k2))
    un = V.axpy(V.axpy(V.axpy(u, m1, k1), m2, k2), m3, k3)
    return un, None, 3, V.finite(un)


TS._impls.update({
    "euler": step_euler,
    "ssp": step_ssp,
    "rk": step_rk,
    "theta": step_theta,
    "beuler": step_theta,   # setType rewrites to theta
    "cn": step_theta,
    "bdf": step_bdf,
    "arkimex": step_arkimex,
    "rosw": step_rosw,
})
