"""TSIRM: two-stage iteration with least-squares residual minimization.

Counterpart of the reference's ``_tsirm`` (``petsc_tpu/ksp/ksp.py:687-749``;
tsirm.c, Couturier/Khodja): inner GMRES(30) cycles from the current
iterate give iterates stored, cyclically, as the 12 rows of S; after each
cycle the least-squares minimizer of ||b - A S^T a|| over span(S) replaces
the iterate when it is better (once 12 are stored). A S^T is one product
of A with the 12-column block: M1 (``csr_spmm``) for an assembled
``aij_csr`` operator (its ``mult_mat``), else one product per column. The
history holds the initial and the final norm, as the reference's.
"""

from __future__ import annotations

import torch

from .common import (KSPConfig, SolveResult, axpy, check_converged, empty_history,
                     finalize_reason, initial_residual, norm, rounder, scalar, tolerances)
from .gmres import solve_gmres
from .impls_tr import small_solve

SIZE_LS = 12


def apply_block(A, S):
    """A S^T for the rows of S, as an (n, k) tensor."""
    X = S.t().contiguous()
    if getattr(A, "mult_mat", None) is not None:
        return A.mult_mat(X)
    return torch.stack([A.mult(s.contiguous()) for s in S], dim=1)


def solve_tsirm(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    rnd = rounder(b.dtype)
    inner_cfg = KSPConfig(max_it=min(30, cfg.max_it), normtype=cfg.normtype,
                          guess_nonzero=True, converged_maxits=True, extra=(30, 0))
    r0 = initial_residual(A, b, x0, cfg)
    dp0 = rnd(float(norm(B.mult(r0))))
    hist = empty_history(cfg, b.dtype)
    hist[0] = dp0
    ttol, atol, dtol_bound = tolerances(dp0, rtol, abstol, divtol, rnd)
    S = torch.zeros((SIZE_LS, b.numel()), dtype=b.dtype, device=b.device)
    neg_one = scalar(-1.0, b)
    x, k, rnorm, its, reason = x0, 0, dp0, 0, 0
    while reason == 0 and its < cfg.max_it:
        res = solve_gmres(A, B, b, x.clone(), rtol, abstol, divtol, inner_cfg)
        x1 = res.x
        S[k % SIZE_LS] = x1
        AS = apply_block(A, S)
        a = small_solve(torch.mm(AS.t(), AS), torch.mv(AS.t(), b), shift=1e-30)
        x_ls = torch.mv(S.t(), a)
        r_ls = float(norm(B.mult(axpy(b, neg_one, A.mult(x_ls)))))
        r_in = float(norm(B.mult(axpy(b, neg_one, A.mult(x1)))))
        better = r_ls < r_in and k + 1 >= SIZE_LS
        x, rnorm = (x_ls, rnd(r_ls)) if better else (x1, rnd(r_in))
        its += res.its
        k += 1
        reason = check_converged(rnorm, ttol, atol, dtol_bound)
    hist[min(its, cfg.max_it)] = rnorm
    return SolveResult(x, its, rnorm, finalize_reason(reason, its, cfg), hist, dp0)
