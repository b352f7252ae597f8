"""GMRES(m) and flexible GMRES.

Counterpart of ``petsc_tpu/ksp/gmres.py`` (src/ksp/ksp/impls/gmres/gmres.c
KSPSolve_GMRES / KSPGMRESCycle, borthog2.c:11 classical Gram-Schmidt with
optional refinement, fgmres/fgmres.c). Semantics kept:

* GMRES preconditions on the left and tests the preconditioned residual
  norm that the Givens recurrence gives; FGMRES preconditions on the
  right, keeps the preconditioned basis Z = B V for the update and tests
  the unpreconditioned norm;
* CGS orthogonalization, refined ``never``, ``ifneeded`` (when the
  correction's norm exceeds 1e-8 of the first projection's) or
  ``always``;
* happy breakdown (``HAPTOL``) converges, a zero rotation otherwise is
  ``DIVERGED_NULL``; a restart after m steps; x updated by
  back-substitution of the triangular system at the end of each cycle.

The reference's ``lax.while_loop`` becomes a Python loop with one host read
per iteration: the projections h = V w and ||w||^2 come back together, the
small Hessenberg work (at most m + 1 scalars: rotations, the residual
recurrence, the back-substitution) runs on the host in float64, and the
norm that the history records and the test compares is rounded to the
solve's dtype (:func:`.common.rounder`). On the card an iteration is the
operator's product, the preconditioner, two products with the basis
(``torch.mv``: V w and V^T h) and the K3 kernel ``axpy_normsq`` for
w <- w - V^T h with ||w||^2 (gmres.py:47 and :79), written straight into
the basis row that w becomes.

On a distributed solve (parallel/mesh.py ``reducing``) the basis holds
each rank's block: the projections V w are each rank's partials, summed
over the ranks (one all-reduce of the k + 1 scalars), and the norms of the
full vectors likewise; the Hessenberg work is then the same on every rank.

cfg.extra = (restart, refine), refine 0 never, 1 ifneeded, 2 always.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.pallas_kernels import axpy_normsq
from ..ops.reduce import fnorm2
from ..parallel.mesh import active_comm, allreduce_active_
from ..sys.error import KSPConvergedReason as KR
from .common import (KSPConfig, NONE, SolveResult, check_converged, empty_history,
                     finalize_reason, rounder, tolerances)

HAPTOL = 1e-10  # gmres->haptol default


def _vnorm(z):
    """||z|| of a full (possibly distributed) vector."""
    if active_comm() is None:
        return fnorm2(z)
    return torch.sqrt(allreduce_active_(torch.sum(z * z)))


class _Arnoldi:
    """One restart cycle's host state: the Givens rotations, the rotated
    right-hand side rs and the triangular factor R, in float64."""

    def __init__(self, m, res0):
        self.cc = np.zeros(m)
        self.ss = np.zeros(m)
        self.rs = np.zeros(m + 1)
        self.rs[0] = res0
        self.R = np.zeros((m + 1, m))

    def step(self, k, h, tt):
        """Column k of the Hessenberg matrix (h, then tt below it): returns
        (|rs[k+1]|, hapend, g)."""
        rs = self.rs
        hapbnd = min(abs(tt / (rs[k] if rs[k] != 0 else 1.0)), HAPTOL)
        hapend = tt < hapbnd
        hh = np.zeros(k + 2)
        hh[:k + 1] = h
        hh[k + 1] = tt
        for i in range(k):              # the earlier rotations
            t = hh[i]
            hh[i] = self.cc[i] * t + self.ss[i] * hh[i + 1]
            hh[i + 1] = -self.ss[i] * t + self.cc[i] * hh[i + 1]
        g = math.sqrt(hh[k] ** 2 + hh[k + 1] ** 2)
        gs = g if g != 0 else 1.0
        c, sn = hh[k] / gs, hh[k + 1] / gs
        self.cc[k], self.ss[k] = c, sn
        hh[k], hh[k + 1] = g, 0.0
        self.R[:k + 2, k] = hh
        rs[k + 1] = -sn * rs[k]
        rs[k] = c * rs[k]
        return abs(rs[k + 1]), hapend, g

    def solve(self, k):
        """y of R[:k, :k] y = rs[:k] by back-substitution."""
        y = np.zeros(k)
        for i in range(k - 1, -1, -1):
            d = self.R[i, i]
            y[i] = (self.rs[i] - self.R[i, i + 1:k] @ y[i + 1:]) / (d if d != 0 else 1.0)
        return y


def _orthogonalize(V, k, w, refine, neg_one):
    """CGS of w against the basis rows V[:k+1], the result written into
    V[k+1]; returns (h, ||V[k+1]||^2) as tensors."""
    Vk = V[:k + 1]
    out = V[k + 1]
    h = allreduce_active_(torch.mv(Vk, w))
    _, nsq = axpy_normsq(neg_one, torch.mv(Vk.t(), h), w, out=out)
    if refine:
        h2 = allreduce_active_(torch.mv(Vk, out))
        if refine == 2:
            _, nsq = axpy_normsq(neg_one, torch.mv(Vk.t(), h2), out, out=out)
            h = h + h2
        else:
            # refine when the correction is large against the projection
            do = fnorm2(h2) > 1e-8 * fnorm2(h)
            w2, nsq2 = axpy_normsq(neg_one, torch.mv(Vk.t(), h2), out)
            out.copy_(torch.where(do, w2, out))
            nsq = torch.where(do, nsq2, nsq)
            h = torch.where(do, h + h2, h)
    return h, nsq


def _gmres(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig, flexible):
    m = int(cfg.extra[0]) if cfg.extra else 30
    refine = int(cfg.extra[1]) if len(cfg.extra) > 1 else 0
    dt = b.dtype
    rnd = rounder(dt)
    x = x0                     # updated in place (the caller's fresh zeros or guess)
    V = torch.empty((m + 1, b.numel()), dtype=dt, device=b.device)
    Z = torch.empty((m, b.numel()), dtype=dt, device=b.device) if flexible else None
    neg_one = torch.full((), -1.0, dtype=dt, device=b.device)

    def start(first):
        """The cycle's first basis vector, unnormalized: B(b - A x) for
        GMRES, b - A x for FGMRES; b itself on a zero initial guess."""
        r = b if first and not cfg.guess_nonzero else b - A.mult(x)
        return r if flexible else B.mult(r)

    z = start(True)
    dp0 = rnd(float(_vnorm(z)))
    hist = empty_history(cfg, dt)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)

    its, rnorm, reason, first = 0, dp0, 0, True
    while first or (reason == 0 and its < cfg.max_it):
        if not first:
            z = start(False)
        res0 = float(_vnorm(z)) if not first else dp0
        torch.div(z, res0 if res0 != 0 else 1.0, out=V[0])
        cyc = _Arnoldi(m, res0)
        k = 0
        while reason == 0 and k < m and its < cfg.max_it:
            if flexible:
                Z[k] = B.mult(V[k])
                w = A.mult(Z[k])
            else:
                w = B.mult(A.mult(V[k]))
            h, nsq = _orthogonalize(V, k, w, refine, neg_one)
            hv = torch.cat([h, nsq.reshape(1)]).cpu().numpy()
            tt = rnd(math.sqrt(float(hv[-1])))
            if tt != 0:
                V[k + 1].div_(tt)
            else:
                V[k + 1].zero_()
            res, hapend, g = cyc.step(k, hv[:-1].astype(np.float64), tt)
            dp = 0.0 if hapend else rnd(res)
            its += 1
            k += 1
            hist[min(its, cfg.max_it)] = dp
            rnorm = dp
            reason = check_converged(dp, ttol, atol, dtol_bound) if cfg.normtype != NONE else 0
            if hapend and reason == 0:
                reason = int(KR.CONVERGED_HAPPY_BREAKDOWN)
            if g == 0 and not hapend:
                reason = int(KR.DIVERGED_NULL)
        if k:
            y = torch.as_tensor(cyc.solve(k), dtype=dt, device=b.device)
            x.add_(torch.mv((Z if flexible else V)[:k].t(), y))
        first = False
    reason = finalize_reason(reason, its, cfg)
    return SolveResult(x, its, rnorm, reason, hist, dp0)


def solve_gmres(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """GMRES(m), left preconditioned (gmres.c)."""
    return _gmres(A, B, b, x0, rtol, abstol, divtol, cfg, flexible=False)


def solve_fgmres(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Flexible GMRES (fgmres.c): right preconditioned, the basis Z = B V
    kept for the update, so the preconditioner may change from step to
    step; convergence on the unpreconditioned residual."""
    return _gmres(A, B, b, x0, rtol, abstol, divtol, cfg, flexible=True)
