"""LGMRES(m, k): GMRES augmented with error approximations.

Counterpart of ``petsc_tpu/ksp/lgmres.py`` (reference
src/ksp/ksp/impls/gmres/lgmres/lgmres.c, Baker, Jessup & Manteuffel):
each restart cycle runs m - a Krylov directions and then a augmentation
directions, the error approximations z_j = x_after - x_before of earlier
cycles (scaled to unit norm, at most k = -ksp_lgmres_augment of them,
default 2); a finished cycle's correction replaces the oldest stored one.
An augmentation step costs no product: its B A z_j is kept from its cycle
(A_AUGVEC), V (Hbar y) with the unrotated Hessenberg.

The Arnoldi step is the port's GMRES step (:mod:`.gmres`: ``torch.mv`` with
the basis, K3 for the orthogonalized vector and its norm, the Givens work
on the host); the cycle's update is x += U^T y with U the cycle's sources
(Krylov vectors or stored z_j). cfg.extra = (restart, refine, augment).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..sys.error import KSPConvergedReason as KR
from .common import (KSPConfig, NONE, SolveResult, axpy, check_converged, empty_history,
                     finalize_reason, norm, rounder, tolerances)
from .gmres import _Arnoldi, _orthogonalize, solve_gmres


def solve_lgmres(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    m = int(cfg.extra[0]) if cfg.extra else 30
    refine = int(cfg.extra[1]) if len(cfg.extra) > 1 else 0
    k_aug = min(int(cfg.extra[2]) if len(cfg.extra) > 2 else 2, m - 1)
    if k_aug <= 0:
        return solve_gmres(A, B, b, x0, rtol, abstol, divtol, cfg)
    dt = b.dtype
    n = b.numel()
    rnd = rounder(dt)
    x = x0
    V = torch.empty((m + 1, n), dtype=dt, device=b.device)
    U = torch.empty((m, n), dtype=dt, device=b.device)
    AUG = torch.zeros((k_aug, n), dtype=dt, device=b.device)
    AAUG = torch.zeros((k_aug, n), dtype=dt, device=b.device)
    neg_one = torch.full((), -1.0, dtype=dt, device=b.device)
    one = torch.ones((), dtype=dt, device=b.device)

    def start(first):
        """B(b - A x), or B b on a zero initial guess in the first cycle."""
        return B.mult(b if first and not cfg.guess_nonzero else axpy(b, neg_one, A.mult(x)))

    z = start(True)
    res0 = float(norm(z))
    dp0 = rnd(res0)
    hist = empty_history(cfg, dt)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)
    its, rnorm, reason, a_ct, ncyc, first = 0, dp0, 0, 0, 0, True
    while first or (reason == 0 and its < cfg.max_it):
        if not first:
            z = start(False)
            res0 = float(norm(z))
        torch.div(z, res0 if res0 != 0 else 1.0, out=V[0])
        n_kry = m - a_ct
        cyc = _Arnoldi(m, res0)
        hes = np.zeros((m + 1, m))        # the unrotated Hessenberg
        kk = 0
        while reason == 0 and kk < m and its < cfg.max_it:
            if kk >= n_kry:
                j = min(kk - n_kry, k_aug - 1)
                U[kk] = AUG[j]
                w = AAUG[j]
            else:
                U[kk] = V[kk]
                w = B.mult(A.mult(V[kk]))
            h, nsq = _orthogonalize(V, kk, w, refine, neg_one)
            hv = torch.cat([h, nsq.reshape(1)]).cpu().numpy().astype(np.float64)
            tt = rnd(math.sqrt(hv[-1]))
            if tt != 0:
                V[kk + 1].div_(tt)
            else:
                V[kk + 1].zero_()
            hes[:kk + 1, kk] = hv[:-1]
            hes[kk + 1, kk] = tt
            res, hapend, g = cyc.step(kk, hv[:-1], tt)
            dp = 0.0 if hapend else rnd(res)
            its += 1
            kk += 1
            hist[min(its, cfg.max_it)] = dp
            rnorm = dp
            reason = check_converged(dp, ttol, atol, dtol_bound) if cfg.normtype != NONE else 0
            if hapend and reason == 0:
                reason = int(KR.CONVERGED_HAPPY_BREAKDOWN)
            if g == 0 and not hapend:
                reason = int(KR.DIVERGED_NULL)
        if kk:
            y = cyc.solve(kk)
            zc = torch.mv(U[:kk].t(), torch.as_tensor(y, dtype=dt, device=b.device))
            azc = torch.mv(V[:kk + 1].t(),
                           torch.as_tensor(hes[:kk + 1, :kk] @ y, dtype=dt, device=b.device))
            x = axpy(x, one, zc)
            zn = float(norm(zc))
            if zn > 0:
                slot = ncyc % k_aug
                AUG[slot] = zc * (1.0 / zn)
                AAUG[slot] = azc * (1.0 / zn)
                a_ct = min(a_ct + 1, k_aug)
        ncyc += 1
        first = False
    reason = finalize_reason(reason, its, cfg)
    return SolveResult(x, its, rnorm, reason, hist, dp0)
