"""More TS types: radau5, irk, basicsymplectic, pseudo, alpha, alpha2,
glee, eimex, mimex and mprk.

Counterpart of ``petsc_tpu/ts/impls_more.py`` (reference
src/ts/impls/symplectic/basicsymplectic, pseudo (pseudo-transient
continuation with SER growth), implicit/alpha and alpha2, irk, the RADAU5
rows, glee.c, eimex.c, mimex.c and multirate/mprk.c). States are tensors
on the Vec's device; implicit stages go through the cached parametric
stage residual of ``ts.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import vecops as V
from ..sys.error import Error, TSConvergedReason as TR
from .ts import TS, _rhs, _snes_stage_solve, _stage_residual


# ---------------------------------------------------------------------
# basicsymplectic: separable H(q, p) = T(p) + V(q)
# ---------------------------------------------------------------------

def setHamiltonianSplit(ts, fq, fp, nq=None):
    """dq/dt = fq(t, p), dp/dt = fp(t, q); the state is u = [q, p] with
    nq = len(q) (half by default)."""
    ts._ham_fq = fq
    ts._ham_fp = fp
    ts._ham_nq = nq
    return ts


TS.setHamiltonianSplit = setHamiltonianSplit

# Yoshida 4th-order coefficients
_Y4 = 2.0 ** (1.0 / 3.0)
_Y4_C = [1.0 / (2 * (2 - _Y4)), (1 - _Y4) / (2 * (2 - _Y4)),
         (1 - _Y4) / (2 * (2 - _Y4)), 1.0 / (2 * (2 - _Y4))]
_Y4_D = [1.0 / (2 - _Y4), -_Y4 / (2 - _Y4), 1.0 / (2 - _Y4), 0.0]


def _symp_coeffs(order):
    if order == 1:
        return [1.0], [1.0]
    if order == 2:                      # velocity Verlet (leapfrog)
        return [0.5, 0.5], [1.0, 0.0]
    if order == 4:
        return _Y4_C, _Y4_D
    raise Error(f"basicsymplectic: order {order} not in (1,2,4)")


def step_symplectic(ts: TS, t, u, dt):
    fq, fp = getattr(ts, "_ham_fq", None), getattr(ts, "_ham_fp", None)
    if fq is None:
        raise Error("basicsymplectic: call setHamiltonianSplit(fq, fp)")
    nq = ts._ham_nq or u.numel() // 2
    order = getattr(ts, "symplectic_order", 2)
    cs, ds = _symp_coeffs(order)
    q, p = u[:nq].contiguous(), u[nq:].contiguous()
    tt = t
    for c, d in zip(cs, ds):
        q = V.axpy(q, c * dt, fq(tt, p))
        if d != 0.0:
            p = V.axpy(p, d * dt, fp(tt, q))
        tt += c * dt
    un = torch.cat([q, p])
    return un, None, order, V.finite(un)


# ---------------------------------------------------------------------
# pseudo: pseudo-transient continuation to steady state
# ---------------------------------------------------------------------

def step_pseudo(ts: TS, t, u, dt):
    """One backward-Euler step; dt grows by SER, dt_{n+1} = dt_n
    ||G_old|| / ||G_new|| (pseudo.c TSPseudoTimeStepDefault)."""
    def build():
        F = ts.ifunction

        def residual(x, tt, dtt, uprev):
            return F(tt + dtt, x, (x - uprev) / dtt)
        return residual

    residual = _stage_residual(ts, ("pseudo",), build)
    un, ok = _snes_stage_solve(ts, residual, (t, dt, u), u)
    if not ok:
        return u, None, 1, False
    fnew = V.norm(_rhs(ts, t + dt, un))
    fold = getattr(ts, "_pseudo_fnorm", None)
    if fold is not None and fnew > 0:
        ts.dt = dt * min(max(fold / fnew, 0.1), ts.pseudo_max_growth)
    ts._pseudo_fnorm = fnew
    if fnew < getattr(ts, "pseudo_fatol", 1e-10):
        ts._reason = TR.CONVERGED_USER   # steady state reached
    return un, None, 1, V.finite(un)


TS.pseudo_max_growth = 10.0


# ---------------------------------------------------------------------
# alpha: generalized-alpha for first-order systems
# ---------------------------------------------------------------------

def step_alpha(ts: TS, t, u, dt):
    """Generalized-alpha (Jansen-Whiting-Hulbert; impls/implicit/alpha)
    from the spectral radius rho_inf (0.2): alpha_m = (3-rho)/(2(1+rho)),
    alpha_f = 1/(1+rho), gamma = 1/2 + alpha_m - alpha_f."""
    rho = getattr(ts, "alpha_radius", 0.2)
    am = 0.5 * (3.0 - rho) / (1.0 + rho)
    af = 1.0 / (1.0 + rho)
    gamma = 0.5 + am - af
    v0 = getattr(ts, "_alpha_v", None)
    if v0 is None:
        v0 = _rhs(ts, t, u)

    def build():
        F = ts.ifunction

        def residual(x, tt, dtt, uprev, vprev):
            v1 = (x - uprev) / (gamma * dtt) - (1.0 - gamma) / gamma * vprev
            ua = uprev + af * (x - uprev)
            va = vprev + am * (v1 - vprev)
            return F(tt + af * dtt, ua, va)
        return residual

    residual = _stage_residual(ts, ("alpha", rho), build)
    un, ok = _snes_stage_solve(ts, residual, (t, dt, u, v0), u)
    if not ok:
        return u, None, 2, False
    ts._alpha_v = (un - u) / (gamma * dt) - (1.0 - gamma) / gamma * v0
    return un, None, 2, V.finite(un)


def step_alpha2(ts: TS, t, u, dt):
    """Generalized-alpha for 2nd-order systems (Chung-Hulbert; alpha2.c):
    alpha_m = (2 rho - 1)/(rho + 1), alpha_f = rho/(rho + 1), gamma = 1/2 -
    alpha_m + alpha_f, beta = (1 - alpha_m + alpha_f)^2 / 4; solves
    F(t_m, u_m, v_m, a_m) = 0 for a_{n+1} (setI2Function). The velocity
    persists on the TS (ts.alpha2_v0 the initial one)."""
    if getattr(ts, "_i2func", None) is None:
        raise Error("alpha2: call setI2Function(F(t, u, v, a)) first")
    rho = float(getattr(ts, "alpha_radius", 0.2))
    am = (2.0 * rho - 1.0) / (rho + 1.0)
    af = rho / (rho + 1.0)
    gamma = 0.5 - am + af
    beta = 0.25 * (1.0 - am + af) ** 2
    v0 = getattr(ts, "_alpha2_v", None)
    a0 = getattr(ts, "_alpha2_a", None)
    if v0 is None or v0.shape != u.shape:
        v0 = V.as_tensor(getattr(ts, "alpha2_v0", np.zeros(u.numel())), like=u)

        def build0():
            f2 = ts._i2func

            def residual(a, tt, uu, vv):
                return f2(tt, uu, vv, a)
            return residual
        res0 = _stage_residual(ts, ("alpha2_init",), build0)
        a0, ok0 = _snes_stage_solve(ts, res0, (t, u, v0), torch.zeros_like(u))
        if not ok0:
            a0 = torch.zeros_like(u)

    def build():
        f2 = ts._i2func

        def residual(a1, tt, dtt, uu, vv, aa):
            u1 = uu + dtt * vv + dtt * dtt * ((0.5 - beta) * aa + beta * a1)
            v1 = vv + dtt * ((1.0 - gamma) * aa + gamma * a1)
            um = (1.0 - af) * u1 + af * uu
            vm = (1.0 - af) * v1 + af * vv
            aam = (1.0 - am) * a1 + am * aa
            return f2(tt + (1.0 - af) * dtt, um, vm, aam)
        return residual

    residual = _stage_residual(ts, ("alpha2", rho), build)
    a1, ok = _snes_stage_solve(ts, residual, (t, dt, u, v0, a0), a0)
    if not ok:
        return u, None, 2, False
    u1 = u + dt * v0 + dt * dt * ((0.5 - beta) * a0 + beta * a1)
    ts._alpha2_v = v0 + dt * ((1.0 - gamma) * a0 + gamma * a1)
    ts._alpha2_a = a1
    return u1, None, 2, V.finite(u1)


# ---------------------------------------------------------------------
# irk (Gauss(2)) and radau5 (Radau IIA(3)): stacked stage systems
# ---------------------------------------------------------------------

_IRK_C = [0.5 - np.sqrt(3) / 6, 0.5 + np.sqrt(3) / 6]
_IRK_A = [[0.25, 0.25 - np.sqrt(3) / 6],
          [0.25 + np.sqrt(3) / 6, 0.25]]
_IRK_B = [0.5, 0.5]

_R6 = np.sqrt(6.0)
_RADAU_C = [(4.0 - _R6) / 10.0, (4.0 + _R6) / 10.0, 1.0]
_RADAU_A = [
    [(88.0 - 7.0 * _R6) / 360.0, (296.0 - 169.0 * _R6) / 1800.0,
     (-2.0 + 3.0 * _R6) / 225.0],
    [(296.0 + 169.0 * _R6) / 1800.0, (88.0 + 7.0 * _R6) / 360.0,
     (-2.0 - 3.0 * _R6) / 225.0],
    [(16.0 - _R6) / 36.0, (16.0 + _R6) / 36.0, 1.0 / 9.0],
]
_RADAU_B = [(16.0 - _R6) / 36.0, (16.0 + _R6) / 36.0, 1.0 / 9.0]


def _collocation_step(ts, t, u, dt, key, A, B, C, order):
    """All stage derivatives solved as one stacked system with the cached
    parametric stage residual."""
    s = len(B)

    def build():
        f = ts.rhs

        def residual(kflat, tt, dtt, uprev):
            k = kflat.reshape(s, -1)
            r = []
            for i in range(s):
                acc = A[i][0] * k[0]
                for j in range(1, s):
                    acc = acc + A[i][j] * k[j]
                r.append(k[i] - f(tt + C[i] * dtt, uprev + dtt * acc))
            return torch.cat(r)
        return residual

    residual = _stage_residual(ts, key, build)
    k0 = torch.cat([_rhs(ts, t, u)] * s)
    kflat, ok = _snes_stage_solve(ts, residual, (t, dt, u), k0)
    if not ok:
        return u, None, order, False
    k = kflat.reshape(s, -1)
    un = u
    for i in range(s):
        un = V.axpy(un, dt * B[i], k[i])
    return un, None, order, V.finite(un)


def step_irk(ts: TS, t, u, dt):
    """Fully implicit Gauss(2) RK (impls/irk), order 4, A-stable."""
    return _collocation_step(ts, t, u, dt, ("irk",), _IRK_A, _IRK_B, _IRK_C, 4)


def step_radau5(ts: TS, t, u, dt):
    """Radau IIA(3), order 5, L-stable: the method of the reference's
    RADAU5 rows, its three stages one stacked system."""
    return _collocation_step(ts, t, u, dt, ("radau5",), _RADAU_A, _RADAU_B, _RADAU_C, 5)


TS._impls.update({
    "radau5": step_radau5,
    "irk": step_irk,
    "basicsymplectic": step_symplectic,
    "symplectic": step_symplectic,
    "pseudo": step_pseudo,
    "alpha": step_alpha,
    "alpha2": step_alpha2,
})


# =====================================================================
# TSGLEE: general linear methods with global error estimation (glee.c)
# =====================================================================

def _glee_tab(name):
    """The explicit GLEE tableaus (glee.c TSGLEERegisterAll; r = 2 items
    carrying (y, y~) or (y, eps))."""
    th = 1.0 / 3.0
    tabs = {
        "23": dict(p=2, A=[[0, 0, 0], [1, 0, 0], [0.25, 0.25, 0]],
                   B=[[1 / 12, 1 / 12, 5 / 6], [1 / 12, 1 / 12, -1 / 6]],
                   U=[[1, 0], [1, 10], [1, -1]],
                   S=[1, 0], F=[1, 0], Ferror=[0, 1]),
        "24": dict(p=2,
                   A=[[0, 0, 0, 0], [0.75, 0, 0, 0],
                      [0.25, 29 / 60, 0, 0],
                      [-21 / 44, 145 / 44, -20 / 11, 0]],
                   B=[[109 / 275, 58 / 75, -37 / 110, 1 / 6],
                      [3 / 11, 0, 75 / 88, -1 / 8]],
                   U=[[0, 1], [75 / 58, -17 / 58], [0, 1], [0, 1]],
                   S=[1, 1], F=[1, 0], Ferror=[-1.0, 1.0]),
        "exrk2a": dict(p=2,
                       A=[[0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0],
                          [0, 0, 0, 0, 0, 0], [0, 0, 0.5, 0, 0, 0],
                          [0, 0, 0.25, 0.25, 0, 0],
                          [0, 0, 0.25, 0.25, 0.5, 0]],
                       B=[[0.5, 0.5, 0, 0, 0, 0],
                          [-2 / 3, -2 / 3, 1 / 3, 1 / 3, 1 / 3, 1 / 3]],
                       U=[[1, 0], [1, 0], [1, 0.75], [1, 0.75], [1, 0.75],
                          [1, 0.75]],
                       S=[1, 0], F=[1, 0], Ferror=[0, 1]),
        "rk32g1": dict(p=3,
                       A=[[0, 0, 0, 0, 0, 0, 0, 0],
                          [0.5, 0, 0, 0, 0, 0, 0, 0],
                          [-1, 2, 0, 0, 0, 0, 0, 0],
                          [1 / 6, 2 / 3, 1 / 6, 0, 0, 0, 0, 0],
                          [0, 0, 0, 0, 0, 0, 0, 0],
                          [-7 / 24, th, 1 / 12, -0.125, 0.5, 0, 0, 0],
                          [7 / 6, -4 / 3, -th, 0.5, -1, 2, 0, 0],
                          [0, 0, 0, 0, 1 / 6, 2 / 3, 1 / 6, 0]],
                       B=[[1 / 6, 2 / 3, 1 / 6, 0, 0, 0, 0, 0],
                          [-1 / 6, -2 / 3, -1 / 6, 0, 1 / 6, 2 / 3, 1 / 6,
                           0]],
                       U=[[1, 0], [1, 0], [1, 0], [1, 0], [1, 1], [1, 1],
                          [1, 1], [1, 1]],
                       S=[1, 0], F=[1, 0], Ferror=[0, 1]),
    }
    t = dict(tabs[name])
    t["A"] = np.asarray(t["A"], dtype=np.float64)
    t["B"] = np.asarray(t["B"], dtype=np.float64)
    t["U"] = np.asarray(t["U"], dtype=np.float64)
    t["c"] = t["A"].sum(axis=1)
    return t


def step_glee(ts: TS, t, u, dt):
    """TSStep_GLEE (glee.c:207): r = 2 carried items Y; s explicit stages
    Y_i = sum_j U_ij Y_j + dt sum_j A_ij f(Y_j); new items Y'_i = Y_i + dt
    sum_j B_ij f(Y_j); u = F.Y', the global error estimate Ferror.Y'. The
    items commit only once the step is accepted (a proposal)."""
    tab = _glee_tab(getattr(ts, "glee_type", "rk32g1"))
    A, B, U, c = tab["A"], tab["B"], tab["U"], tab["c"]
    S, F, Fer, p = tab["S"], tab["F"], tab["Ferror"], tab["p"]
    s = A.shape[0]
    prop = getattr(ts, "_glee_prop", None)
    if prop is not None and prop[0].shape == u.shape and torch.equal(prop[0], u):
        ts._glee_Y = prop[1]          # the previous proposal was accepted
    ts._glee_prop = None
    Y = getattr(ts, "_glee_Y", None)
    if ts._steps == 0 or Y is None or Y[0].shape != u.shape:
        Y = [Si * u for Si in S]      # S-init (zero initial global error)
    Ydot = []
    for i in range(s):
        yi = U[i, 0] * Y[0] + U[i, 1] * Y[1]
        for j in range(i):
            if A[i, j] != 0:
                yi = yi + dt * A[i, j] * Ydot[j]
        Ydot.append(_rhs(ts, t + c[i] * dt, yi))
    Ynew = []
    for i in range(2):
        yi = Y[i].clone()
        for j in range(s):
            if B[i][j] != 0:
                yi = yi + dt * B[i][j] * Ydot[j]
        Ynew.append(yi)
    unew = F[0] * Ynew[0] + F[1] * Ynew[1]
    err = Fer[0] * Ynew[0] + Fer[1] * Ynew[1]
    ts._glee_prop = (unew, Ynew)
    return unew, (err if ts.adapt.kind != "none" else None), p, V.finite(unew)


# =====================================================================
# TSEIMEX: extrapolated partitioned IMEX (eimex.c); TSMIMEX
# =====================================================================

def step_eimex(ts: TS, t, u, dt):
    """TSStep_EIMEX (eimex.c): T[i][0] by i+1 sub-steps of the first-order
    partitioned IMEX Euler, then T[i][j] = T[i][j-1] + (T[i][j-1] -
    T[i-1][j-1]) / (n_i/n_{i-j} - 1); ts.eimex_max_rows rows (3)."""
    nrows = int(getattr(ts, "eimex_max_rows", 3))
    fe = ts._rhs or (lambda tt, uu: torch.zeros_like(uu))

    if ts._ifunc is None:
        def euler_substeps(nsub):
            h = dt / nsub
            v = u
            tt = t
            for _ in range(nsub):
                v = V.axpy(v, h, fe(tt, v))
                tt += h
            return v, True
    else:
        def build():
            fi_ = ts._ifunc
            fe_ = ts._rhs

            def residual(x, tt, hh, uprev):
                r = fi_(tt, x, (x - uprev) / hh)
                if fe_ is not None:
                    r = r - fe_(tt - hh, uprev)
                return r
            return residual
        residual = _stage_residual(ts, ("eimex",), build)

        def euler_substeps(nsub):
            h = dt / nsub
            v = u
            tt = t
            allok = True
            for _ in range(nsub):
                v, ok = _snes_stage_solve(ts, residual, (tt + h, h, v), v)
                allok = allok and ok
                tt += h
            return v, allok

    ns = [i + 1 for i in range(nrows)]      # harmonic sequence 1, 2, 3, ...
    T = []
    ok = True
    for i in range(nrows):
        ti0, okk = euler_substeps(ns[i])
        ok = ok and okk
        row = [ti0]
        for j in range(1, i + 1):
            q = ns[i] / ns[i - j]
            row.append(row[j - 1] + (row[j - 1] - T[i - 1][j - 1]) / (q - 1.0))
        T.append(row)
    unew = T[nrows - 1][nrows - 1]
    err = (unew - T[nrows - 1][nrows - 2]) if nrows > 1 else None
    return (unew, err if ts.adapt.kind != "none" else None, nrows,
            ok and V.finite(unew))


def step_mimex(ts: TS, t, u, dt):
    """TSMIMEX (mimex.c): one backward-Euler solve on the IFunction with
    the explicit RHS frozen at the step start, EIMEX's one-row step."""
    saved = getattr(ts, "eimex_max_rows", None)
    ts.eimex_max_rows = 1
    try:
        return step_eimex(ts, t, u, dt)
    finally:
        if saved is None:
            del ts.eimex_max_rows
        else:
            ts.eimex_max_rows = saved


# =====================================================================
# TSMPRK: multirate partitioned RK (multirate/mprk.c)
# =====================================================================

def _mprk_tableau2(ratio, Abase, bbase):
    """TSMPRKGenerateTableau2 (mprk.c:69): the base tableau repeated per
    subcycle; the slow partition keeps the base blocks with b/ratio
    weights, the fast one scales them by 1/ratio and carries completed
    subcycles through b/ratio blocks."""
    s = len(bbase)
    ns = ratio * s
    A1 = np.zeros((ns, ns))
    A2 = np.zeros((ns, ns))
    b1 = np.zeros(ns)
    b2 = np.zeros(ns)
    for k in range(ratio):
        A1[k * s:(k + 1) * s, k * s:(k + 1) * s] = Abase
        A2[k * s:(k + 1) * s, k * s:(k + 1) * s] = Abase / ratio
        for l in range(k):
            A2[k * s:(k + 1) * s, l * s:(l + 1) * s] = np.tile(bbase / ratio, (s, 1))
        b1[k * s:(k + 1) * s] = bbase / ratio
        b2[k * s:(k + 1) * s] = bbase / ratio
    return A1, b1, A2, b2


def step_mprk(ts: TS, t, u, dt):
    """TSStep_MPRK: explicit partitioned RK over the "slow" and "fast"
    RHS splits (setRHSSplit), ts.mprk_ratio fast sub-steps per slow step
    (2), base scheme RK2A, as one partitioned tableau."""
    ratio = int(getattr(ts, "mprk_ratio", 2))
    splits = getattr(ts, "_rhs_splits", {})
    if "slow" not in splits or "fast" not in splits:
        raise Error("mprk: setRHSSplit('slow', fs) and ('fast', ff) first")
    fs, iss = splits["slow"]
    ff, isf = splits["fast"]

    def f_of(fn, iset, tt, y):
        out = V.flat(fn(tt, y))
        if iset is not None:
            keep = torch.zeros_like(out, dtype=torch.bool)
            keep[torch.as_tensor(iset, device=out.device)] = True
            out = torch.where(keep, out, torch.zeros_like(out))
        return out

    A1, b1, A2, b2 = _mprk_tableau2(ratio, np.array([[0.0, 0.0], [1.0, 0.0]]),
                                    np.array([0.5, 0.5]))
    c = A2.sum(axis=1)
    ns = len(b1)
    Fs, Ff = [], []
    for i in range(ns):
        y = u
        for j in range(i):
            if A1[i, j] != 0:
                y = y + dt * A1[i, j] * Fs[j]
            if A2[i, j] != 0:
                y = y + dt * A2[i, j] * Ff[j]
        Fs.append(f_of(fs, iss, t + c[i] * dt, y))
        Ff.append(f_of(ff, isf, t + c[i] * dt, y))
    un = u
    for j in range(ns):
        un = un + dt * (b1[j] * Fs[j] + b2[j] * Ff[j])
    return un, None, 2, V.finite(un)


TS._impls.update({
    "mimex": step_mimex,
    "mprk": step_mprk,
    "glee": step_glee,
    "eimex": step_eimex,
})
