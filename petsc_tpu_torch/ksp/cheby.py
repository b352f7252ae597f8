"""KSP Chebyshev and the Chebyshev smoothers of PCMG.

Counterpart of ``petsc_tpu/ksp/cheby.py`` (reference
src/ksp/ksp/impls/cheby/cheby.c: KSPSolve_Chebyshev, the default esteig
transform (0, 0.1; 0, 1.1) for multigrid smoothing, noisy-start
eigenvalue estimation cheby.c:74-115).

The smoothers take the Jacobi inverse diagonal ``dinv`` as a vector
(the reference takes the product ``pcmult``; PCMG's smoothing PC is
Jacobi) so that the whole elementwise tail of each step after its SpMV
is one launch of the hand kernel C1
(:func:`ops.pallas_kernels.cheby_update`). Another smoothing PC (the
aggregate-block smoother) comes as the function z = pc(r): r is then
formed first (K2), and the step's tail is the PC's fused step where it
has one (``pc.fused``: the aggregate-block smoother's A1 with C1's z mode
as its epilogue, one launch), else pc(r) and C1's z mode. They own r and
p, and update x in place. The reference's ``lax.while_loop`` in
:func:`solve_chebyshev` becomes a Python loop with one host read of the
norm per iteration, as in ``impls_basic.solve_cg``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pallas_kernels import cheby_update, cheby_update_z, triad
from ..ops.reduce import fnorm2
from ..sys.error import KSPConvergedReason as KR
from .common import (KSPConfig, NONE, SolveResult, check_converged,
                     empty_history, finalize_reason, initial_residual, rounder,
                     tolerances)
from .impls_basic import _dp


def pc_step(pc, mode, r, p, x, c, beta=1.0, a=0.0):
    """A step's tail with the smoothing PC z = pc(r), r formed: p = c z
    (first_z) or a p + c z (step_z), then x += beta p, in place. One
    launch of the PC's fused step where it offers one, else pc(r) and C1's
    z mode."""
    fused = getattr(pc, "fused", None)
    if fused is not None:
        fused(mode, r, p, x, c, beta, a)
    else:
        cheby_update_z(mode, p, x, pc(r), c, beta, a)


def cheby_smooth(amult, dinv, b, x, its: int, emin, emax):
    """x <- Chebyshev(its) of the first kind applied to A x = b from x,
    with the Jacobi preconditioner dinv (the classical preconditioned
    three-term recurrence on [emin, emax]). x is updated in place and
    returned."""
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    r, p = torch.empty_like(b), torch.empty_like(b)
    if callable(dinv):
        minus_one = torch.full((), -1.0, dtype=b.dtype, device=b.device)
        triad(b, amult(x), minus_one, out=r)
        pc_step(dinv, "first_z", r, p, x, 1.0 / theta)
        for _ in range(1, its):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            triad(r, amult(p), minus_one, out=r)
            pc_step(dinv, "step_z", r, p, x, 2.0 * rho_new / delta, a=rho_new * rho)
            rho = rho_new
        return x
    # r = b - A x; p = z / theta; x += p
    cheby_update("first", r, p, x, amult(x), dinv, 1.0 / theta, b=b)
    for _ in range(1, its):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        # r -= A p; p = rho_new rho p + (2 rho_new / delta) z; x += p
        cheby_update("step", r, p, x, amult(p), dinv, 2.0 * rho_new / delta,
                     a=rho_new * rho)
        rho = rho_new
    return x


def _opt4_betas(m):
    """Optimized fourth-kind damping factors beta_k (Lottes 2022, the
    closed-form fit the reference's opt.fourth uses)."""
    ks = np.arange(1, m + 1, dtype=np.float64)
    return (1.0 - (ks - 1.0) / (2.0 * m)) * (2.0 * m + 1.0) / (2.0 * m)


def cheby_smooth4(amult, dinv, b, x, its: int, emax, optimized=False):
    """Fourth-kind Chebyshev smoother (cheby.c KSP_CHEBYSHEV_FOURTH /
    OPT_FOURTH, Lottes) on (0, emax], needing no emin:

        d_1 = (4/(3 rho)) B r,          x += beta_1 d_1
        d_k = ((2k-3)/(2k+1)) d_{k-1} + ((8k-4)/((2k+1) rho)) B r

    with r -= A d_k between steps. x is updated in place and returned."""
    rho = float(emax)
    bet = _opt4_betas(its) if optimized else np.ones(its)
    r, d = torch.empty_like(b), torch.empty_like(b)
    if callable(dinv):
        minus_one = torch.full((), -1.0, dtype=b.dtype, device=b.device)
        triad(b, amult(x), minus_one, out=r)
        pc_step(dinv, "first_z", r, d, x, 4.0 / (3.0 * rho), beta=float(bet[0]))
        for k in range(2, its + 1):
            triad(r, amult(d), minus_one, out=r)
            pc_step(dinv, "step_z", r, d, x, (8.0 * k - 4.0) / ((2.0 * k + 1.0) * rho),
                    beta=float(bet[k - 1]), a=(2.0 * k - 3.0) / (2.0 * k + 1.0))
        return x
    cheby_update("first", r, d, x, amult(x), dinv, 4.0 / (3.0 * rho), beta=float(bet[0]), b=b)
    for k in range(2, its + 1):
        # the reference's r -= A d of the previous step is this launch's w
        cheby_update("step", r, d, x, amult(d), dinv,
                     (8.0 * k - 4.0) / ((2.0 * k + 1.0) * rho),
                     beta=float(bet[k - 1]), a=(2.0 * k - 3.0) / (2.0 * k + 1.0))
    # the reference's last r -= A d is never read (XLA drops it); skipped
    return x


def estimate_emax(amult, dinv, n, iters=10, seed=7, dtype=torch.float64, device=None):
    """Largest eigenvalue of D^-1 A by power iteration from numpy's
    ``default_rng(seed)`` (the reference's host estimate, agg.c:1875).
    Returns a Python float."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.random(n) - 0.5, dtype=dtype, device=device)
    lam = 1.0
    for _ in range(iters):
        w = dinv * amult(v)
        lam = float(fnorm2(w))
        v = w / lam
    return lam


def solve_chebyshev(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    """Chebyshev as a registered KSP type, any PC. cfg.extra = (emin, emax)."""
    emin, emax = cfg.extra[0], cfg.extra[1]
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma1 = theta / delta

    r0 = initial_residual(A, b, x0, cfg)
    x = x0 if cfg.guess_nonzero else torch.zeros_like(b)
    z = B.mult(r0)
    rnd = rounder(b.dtype)
    dp0 = rnd(_dp(cfg.normtype, r0, z))
    hist = empty_history(cfg, b.dtype)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)

    p = z / theta
    x = x + p
    r = r0 - A.mult(p)
    z = B.mult(r)
    dp = rnd(_dp(cfg.normtype, r, z))
    hist[1] = dp
    reason = check_converged(dp, ttol, atol, dtol_bound) if cfg.normtype != NONE else 0
    its, rho = 1, 1.0 / sigma1
    while reason == 0 and its < cfg.max_it:
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        p = rho_new * rho * p + (2.0 * rho_new / delta) * z
        x = x + p
        r = r - A.mult(p)
        z = B.mult(r)
        dp = rnd(_dp(cfg.normtype, r, z))
        its += 1
        hist[its] = dp
        reason = check_converged(dp, ttol, atol, dtol_bound) if cfg.normtype != NONE else 0
        rho = rho_new
    reason = finalize_reason(reason, its, cfg)
    if cfg.normtype == NONE and its >= cfg.max_it:
        reason = int(KR.CONVERGED_ITS)
    return SolveResult(x, its, dp, reason, hist, dp0)
