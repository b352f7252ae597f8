"""SNESLineSearch: globalization for Newton-type methods.

Counterpart of ``petsc_tpu/snes/linesearch.py`` (reference
src/snes/linesearch/: SNESLineSearchApply linesearch.c:622; bt cubic or
quadratic Armijo backtracking with alpha 1e-4, basic full step, l2
minimisation of ||F|| along the direction, cp critical-point secant,
secant, bisection, nleqerr).

Contract: apply(x, y, f, fnorm) -> (x_new, f_new, fnorm_new, lam, ok) with
x_new = x - lam y (PETSc's sign). x, y and f are tensors on the Vec's
device; each norm and inner product is one K4 launch and one host read,
each trial point one K2 launch.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops import vecops as V


class LineSearch:
    def __init__(self, snes, kind="bt"):
        self.snes = snes
        self.kind = kind
        self.alpha = 1e-4          # -snes_linesearch_alpha
        self.damping = 1.0
        self.minlambda = 1e-12
        self.max_its = 40          # backtrack steps / secant its
        self.order = 3             # cubic (2 = quadratic)

    def set_from_options(self):
        o = self.snes.opt
        t = o("get_string", "snes_linesearch_type", None)
        if t:
            self.kind = t
        a = o("get_real", "snes_linesearch_alpha", None)
        if a:
            self.alpha = a
        d = o("get_real", "snes_linesearch_damping", None)
        if d:
            self.damping = d
        n = o("get_int", "snes_linesearch_order", None)
        if n:
            self.order = n

    def apply(self, x, y, f, fnorm):
        fn = {"bt": self._bt, "basic": self._basic, "none": self._basic,
              "l2": self._l2, "cp": self._cp, "secant": self._secant,
              "bisection": self._bisection,
              "nleqerr": self._nleqerr}.get(self.kind)
        if fn is None:
            raise KeyError(f"unknown linesearch type {self.kind}")
        n0 = self.snes._nfuncs
        out = fn(x, y, f, fnorm)
        self.snes._ls_its.append(self.snes._nfuncs - n0)
        return out

    def _eval(self, x):
        F = self.snes._eval_F(x)
        return F, V.norm(F)

    def _step(self, x, lam, y):
        return V.axpy(x, -lam, y)

    def _secant(self, x, y, f, fnorm):
        """Secant iteration on the derivative of phi(lam) = 0.5||F(x - lam
        y)||^2, approximated by finite differences of phi."""
        def phi(lam):
            _, gn = self._eval(self._step(x, lam, y))
            return 0.5 * gn * gn

        l0, l1 = 0.0, self.damping
        p0 = 0.5 * fnorm * fnorm
        p1 = phi(l1)
        h = 1e-4 * max(abs(l1), 1.0)
        for _ in range(min(self.max_its, 12)):
            g1 = (phi(l1 + h) - p1) / h
            g0 = (phi(l0 + h) - p0) / h
            denom = g1 - g0
            if abs(denom) < 1e-300:
                break
            l2 = l1 - g1 * (l1 - l0) / denom
            if not np.isfinite(l2) or l2 <= self.minlambda:
                break
            l0, p0 = l1, p1
            l1 = l2
            p1 = phi(l1)
            if abs(l1 - l0) < 1e-8 * max(abs(l1), 1.0):
                break
        if p1 >= 0.5 * fnorm * fnorm:     # no decrease: fall back to bt
            return self._bt(x, y, f, fnorm)
        xn = self._step(x, l1, y)
        fn_, gnorm = self._eval(xn)
        return xn, fn_, gnorm, l1, np.isfinite(gnorm)

    def _bisection(self, x, y, f, fnorm):
        """Bisection on the sign of phi's derivative over (0, damping]."""
        def dphi(lam, h=1e-6):
            _, ga = self._eval(self._step(x, lam + h, y))
            _, gb = self._eval(self._step(x, lam - h, y))
            return (0.5 * ga * ga - 0.5 * gb * gb) / (2 * h)

        lo, hi = 0.0, self.damping
        dhi = dphi(hi)
        if dhi <= 0:                      # monotone decrease: take full
            lam = hi
        else:
            lam = 0.5 * (lo + hi)
            for _ in range(min(self.max_its, 30)):
                d = dphi(lam)
                if d > 0:
                    hi = lam
                else:
                    lo = lam
                lam = 0.5 * (lo + hi)
                if hi - lo < 1e-8:
                    break
        xn = self._step(x, lam, y)
        fn_, gnorm = self._eval(xn)
        if gnorm >= fnorm:
            return self._bt(x, y, f, fnorm)
        return xn, fn_, gnorm, lam, np.isfinite(gnorm)

    def _nleqerr(self, x, y, f, fnorm):
        """Deuflhard's affine-covariant NLEQ-ERR damping
        (linesearchnleqerr.c), with the a-posteriori update
        lam' = min(1, 1/h)."""
        lam = self.damping
        if V.normsq(y) == 0:
            return x, f, fnorm, 0.0, False
        for _ in range(min(self.max_its, 20)):
            xn = self._step(x, lam, y)
            fn_, gnorm = self._eval(xn)
            if not np.isfinite(gnorm):
                lam *= 0.5
                continue
            diff = V.axpy(fn_, -(1.0 - lam), f)
            h_est = 2.0 * V.norm(diff) / max(lam * lam * fnorm, 1e-300)
            lam_new = min(1.0, 1.0 / max(h_est, 1e-300))
            if gnorm < fnorm or lam <= self.minlambda:
                return xn, fn_, gnorm, lam, gnorm < fnorm * (1 + 1e-12)
            lam = max(min(lam_new, 0.5 * lam), self.minlambda)
        return self._bt(x, y, f, fnorm)

    def _basic(self, x, y, f, fnorm):
        lam = self.damping
        xn = self._step(x, lam, y)
        fn_, gnorm = self._eval(xn)
        return xn, fn_, gnorm, lam, np.isfinite(gnorm)

    def _bt(self, x, y, f, fnorm):
        """Cubic or quadratic backtracking (linesearchbt.c): Armijo
        decrease on phi(lam) = 0.5||F(x - lam y)||^2 with initial slope
        -fnorm^2 (an exact Newton step)."""
        phi0 = 0.5 * fnorm * fnorm
        initslope = -fnorm * fnorm
        lam = self.damping
        lam_prev, phi_prev = None, None
        xn = self._step(x, lam, y)
        fn_, gnorm = self._eval(xn)
        phi = 0.5 * gnorm * gnorm
        for _ in range(self.max_its):
            if np.isfinite(phi) and phi <= phi0 + self.alpha * lam * initslope:
                return xn, fn_, gnorm, lam, True
            if lam <= self.minlambda:
                break
            if lam_prev is None or self.order == 2:
                denom = 2.0 * (phi - phi0 - lam * initslope)
                lam_new = -initslope * lam * lam / denom \
                    if denom > 0 else 0.5 * lam
            else:
                t1 = phi - phi0 - lam * initslope
                t2 = phi_prev - phi0 - lam_prev * initslope
                den = lam - lam_prev
                a = (t1 / lam ** 2 - t2 / lam_prev ** 2) / den
                b = (-lam_prev * t1 / lam ** 2 + lam * t2 / lam_prev ** 2) / den
                if a == 0:
                    lam_new = -initslope / (2.0 * b)
                else:
                    d = max(b * b - 3.0 * a * initslope, 0.0)
                    lam_new = (-b + math.sqrt(d)) / (3.0 * a)
            if not np.isfinite(lam_new):
                lam_new = 0.5 * lam
            lam_prev, phi_prev = lam, phi
            lam = float(np.clip(lam_new, 0.1 * lam, 0.5 * lam))
            xn = self._step(x, lam, y)
            fn_, gnorm = self._eval(xn)
            phi = 0.5 * gnorm * gnorm
        return xn, fn_, gnorm, lam, False

    def _l2(self, x, y, f, fnorm):
        """Minimise ||F(x - lam y)|| along the direction (linesearchl2.c
        role): a quadratic-fit refinement with a halving fallback."""
        g0 = fnorm * fnorm
        lam = self.damping
        best = (None, None, np.inf, 0.0)
        for _ in range(max(4, min(self.max_its, 12))):
            xn = self._step(x, lam, y)
            fn_, gnorm = self._eval(xn)
            g = gnorm * gnorm
            if np.isfinite(gnorm) and gnorm < best[2]:
                best = (xn, fn_, gnorm, lam)
            if np.isfinite(g) and g < g0:
                xm = self._step(x, 0.5 * lam, y)
                fm, gm = self._eval(xm)
                if np.isfinite(gm) and gm < best[2]:
                    best = (xm, fm, gm, 0.5 * lam)
                denom = g0 - 2 * gm * gm + g
                if denom > 0:
                    lam_q = lam * (0.25 * (3 * g0 - 4 * gm * gm + g)) / denom
                    lam_q = float(np.clip(lam_q, 0.05 * lam, lam))
                    xq = self._step(x, lam_q, y)
                    fq, gq = self._eval(xq)
                    if np.isfinite(gq) and gq < best[2]:
                        best = (xq, fq, gq, lam_q)
                break
            lam *= 0.5
            if lam < self.minlambda:
                break
        if best[0] is None:
            xn = self._step(x, self.minlambda, y)
            fn_, gnorm = self._eval(xn)
            return xn, fn_, gnorm, self.minlambda, False
        xn, fn_, gnorm, lam = best
        return xn, fn_, gnorm, lam, gnorm < fnorm

    def _cp(self, x, y, f, fnorm):
        """Critical-point secant on s(lam) = <F(x - lam y), y>
        (linesearchcp.c)."""
        lam, lam_old = self.damping, 0.0
        s_old = V.dot(f, y)
        xn = self._step(x, lam, y)
        fn_, gnorm = self._eval(xn)
        s = V.dot(fn_, y)
        for _ in range(max(1, min(self.max_its, 10))):
            if s == s_old or lam == lam_old:
                break
            lam_new = lam - s * (lam - lam_old) / (s - s_old)
            lam_old, s_old = lam, s
            lam = float(np.clip(lam_new, self.minlambda, 10.0))
            xn = self._step(x, lam, y)
            fn_, gnorm = self._eval(xn)
            s = V.dot(fn_, y)
        return xn, fn_, gnorm, lam, np.isfinite(gnorm)
