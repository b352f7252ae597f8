"""KSPTCQMR: Tony Chan's transpose-free QMR variant.

Counterpart of ``petsc_tpu/ksp/tcqmr.py`` (reference
src/ksp/ksp/impls/tcqmr/tcqmr.c): squared-Lanczos vectors and two
trailing Givens rotations; the reported norm is the QMR bound
rnorm0 sqrt(its + 2) prod|s|. Three products with B A per iteration; the
rotations' scalars stay on the device, the warm-up branches (its <= 2)
are host branches.
"""

from __future__ import annotations

import math

import torch

from .common import KSPConfig, axpy, dot, initial_residual, norm, nz, scalar
from .impls_more import _Loop


def solve_tcqmr(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    x = x0
    r = B.mult(initial_residual(A, b, x0, cfg))
    rnorm0 = norm(r)
    lp = _Loop(cfg, b, float(rnorm0), rtol, abstol, divtol)

    def BA(w):
        return B.mult(A.mult(w))

    u = r * (1.0 / nz(rnorm0))
    v = v0 = u
    zv = torch.zeros_like(b)
    um1 = vm1 = p = pvec1 = pvec2 = zv
    zero, one = scalar(0.0, b), scalar(1.0, b)
    theta = ep = cl1 = sl1 = cl = sl = zero
    sprod = f = Gamma = rhom1 = one
    tau_n1 = rnorm0
    while lp.live():
        its = lp.its + 1
        y = BA(u)
        rho = dot(u, v0)
        alpha = dot(y, v0) / nz(rho)
        deltmp = alpha
        zk = axpy(y, -alpha, u)
        beta = rho / nz(f * rhom1)
        rhom1 = rho
        utmp = axpy(zk, -2.0 * beta, p)
        up1 = axpy(axpy(BA(utmp), -alpha, utmp), f * beta * beta, um1)
        f = 1.0 / nz(norm(up1))
        up1 = up1 * f
        p = f * axpy(zk, -beta, p)
        um1, u = u, up1
        beta = beta / nz(Gamma)
        eptmp = beta
        vp1 = axpy(axpy(BA(v), -alpha, v), -beta, vm1)
        Gamma = norm(vp1)
        vp1 = vp1 * (1.0 / nz(Gamma))
        vm1, v = v, vp1
        if its > 2:
            theta = sl1 * beta
            eptmp = -cl1 * beta
        if its > 1:
            ep = -cl * eptmp + sl * alpha
            deltmp = -sl * eptmp - cl * alpha
        big = torch.abs(Gamma) > torch.abs(deltmp)
        ta1 = -deltmp / nz(Gamma)
        s_a = 1.0 / torch.sqrt(1.0 + ta1 * ta1)
        c_a = s_a * ta1
        ta2 = -Gamma / nz(deltmp)
        c_b = 1.0 / torch.sqrt(1.0 + ta2 * ta2)
        s_b = c_b * ta2
        c = torch.where(big, c_a, c_b)
        sg = torch.where(big, s_a, s_b)
        delta = -c * deltmp + sg * Gamma
        tau_n = -c * tau_n1
        tau_n1 = -sg * tau_n1
        pvec = axpy(axpy(vm1, -theta, pvec2), -ep, pvec1) * (1.0 / nz(delta))
        x = axpy(x, tau_n, pvec)
        sprod = sprod * torch.abs(sg)
        rnorm = rnorm0 * math.sqrt(its + 2.0) * sprod
        pvec2, pvec1 = pvec1, pvec
        cl1, sl1, cl, sl = cl, sl, c, sg
        lp.step(float(rnorm))
    return lp.result(x)
