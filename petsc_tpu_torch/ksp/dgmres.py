"""KSPDGMRES: GMRES with adaptive eigen-deflated restarts (dgmres and, as
in the reference, agmres).

Counterpart of ``petsc_tpu/ksp/dgmres.py`` (reference
src/ksp/ksp/impls/gmres/dgmres/dgmres.c). At each restart the
smallest-magnitude Ritz pairs of the preconditioned operator are taken
from the cycle's Hessenberg and the deflation

    M_D^{-1} = I + U (|lambda_max| T^{-1} - I) (U^T U)^{-1} U^T,
    T = U^T (B A) U

is composed with the PC for the next cycles. Host-driven, as the
reference's: each cycle is a CGS2 Arnoldi of m steps on the device (no
early stop; the basis products on ``torch.mv``, the subtractions on K2 and
the second with the new vector's norm on K3, as GMRES's; B A on the
operator and PC),
the Hessenberg comes to the host once per cycle, where the least-squares
update, the eigenproblem and the k x k inverses run in numpy; x, r, V and U
stay on the device. U is kept as kpad = kmax + 2 rows (room for a
conjugate partner); its unused rows are zero. The history holds the
initial norm and the true preconditioned residual norm after each cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pallas_kernels import axpy_normsq
from ..sys.error import KSPConvergedReason as KR
from .common import axpy, dot, norm, residual, scalar


def solve_dgmres_host(ksp, A, B, b, x0):
    """The deflated-restart loop: returns (x, its, rnorm, reason, history,
    rnorm0)."""
    m = int(ksp._params.get("restart", 30))
    kmax = int(ksp._params.get("max_eigen",
                               ksp.opt("get_int", "ksp_dgmres_max_eigen", None) or 8))
    kextract = int(ksp.opt("get_int", "ksp_dgmres_eigen", None) or 1)
    kpad = kmax + 2
    n = b.numel()
    dt, dev = b.dtype, b.device
    x = x0
    U = torch.zeros((kpad, n), dtype=dt, device=dev)
    Tinv = torch.zeros((kpad, kpad), dtype=dt, device=dev)
    Xinv = torch.zeros((kpad, kpad), dtype=dt, device=dev)
    lam_max = 1.0
    kcount = 0
    one, neg_one = scalar(1.0, b), scalar(-1.0, b)

    def defl(v):
        w = torch.mv(Xinv, torch.mv(U, v))
        return axpy(v, one, torch.mv(U.t(), lam_max * torch.mv(Tinv, w) - w))

    r = B.mult(residual(A, b, x))
    rnorm0 = float(norm(r))
    ttol = max(ksp.rtol * rnorm0, ksp.abstol)
    hist = [rnorm0]
    its, reason, rnorm = 0, 0, rnorm0
    if rnorm0 <= ksp.abstol:
        return x, 0, rnorm0, int(KR.CONVERGED_ATOL), hist, rnorm0
    V = torch.zeros((m + 1, n), dtype=dt, device=dev)
    while its < ksp.max_it and reason == 0:
        # CGS2 Arnoldi of m steps on B A M_D^{-1}
        beta = float(norm(r))
        V.zero_()
        V[0] = r / (beta if beta > 0 else 1.0)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        for j in range(m):
            w = B.mult(A.mult(defl(V[j])))
            Vj = V[:j + 1]
            h1 = torch.mv(Vj, w)
            w = axpy(w, neg_one, torch.mv(Vj.t(), h1))
            h2 = torch.mv(Vj, w)
            w, hsq = axpy_normsq(neg_one, torch.mv(Vj.t(), h2), w)
            hb = torch.sqrt(hsq)
            H[:j + 1, j] = h1 + h2
            H[j + 1, j] = hb
            V[j + 1] = torch.where(hb > 1e-30, w / torch.where(hb > 1e-30, hb, 1.0),
                                   torch.zeros_like(w))
        Hh = H.cpu().numpy().astype(np.float64)
        sub = np.abs(np.diag(Hh[1:, :]))
        brk = np.nonzero(sub < 1e-14)[0]
        mj = min(int(brk[0]) + 1 if len(brk) else m, ksp.max_it - its)
        its += mj
        e1 = np.zeros(mj + 1)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(Hh[:mj + 1, :mj], e1, rcond=None)
        ypad = np.zeros(m)
        ypad[:mj] = y
        x = axpy(x, one, defl(torch.mv(V[:m].t(),
                                       torch.as_tensor(ypad, dtype=dt, device=dev))))
        r = B.mult(residual(A, b, x))
        rnorm = float(norm(r))
        hist.append(rnorm)
        if rnorm <= ttol:
            reason = int(KR.CONVERGED_ATOL if rnorm < ksp.abstol else KR.CONVERGED_RTOL)
            break
        if not np.isfinite(rnorm):
            reason = int(KR.DIVERGED_NANORINF)
            break
        if rnorm > ksp.divtol * rnorm0:
            reason = int(KR.DIVERGED_DTOL)
            break
        # the deflation update: the smallest-|lambda| Ritz pairs
        if kcount < kmax and mj >= 2:
            lam, Y = np.linalg.eig(Hh[:mj, :mj])
            order = np.argsort(np.abs(lam))
            lam_max = float(np.max(np.abs(lam)))
            take = []
            for idx in order:
                if len(take) >= kextract:
                    break
                take.append(idx)
                if abs(lam[idx].imag) > 1e-12 and len(take) < kextract + 1:
                    conj = int(np.argmin(np.abs(lam - np.conj(lam[idx]))))
                    if conj not in take:
                        take.append(conj)
            take = take[: kpad - kcount]
            Yr = np.zeros((kpad, m))
            Yr[kcount:kcount + len(take), :mj] = np.real(Y[:, take]).T
            U, T, X = _basis(A, B, V[:m], torch.as_tensor(Yr, dtype=dt, device=dev), U)
            kcount = min(kcount + len(take), kpad)
            act = np.abs(np.diag(X)) > 1e-12
            act[kcount:] = False
            for M_ in (T, X):
                M_[~act, :] = 0.0
                M_[:, ~act] = 0.0
                M_[np.ix_(~act, ~act)] = np.eye(int((~act).sum()))
            try:
                mask = np.outer(act, act).astype(float)
                Tinv = torch.as_tensor(np.linalg.inv(T) * mask, dtype=dt, device=dev)
                Xinv = torch.as_tensor(np.linalg.inv(X) * mask, dtype=dt, device=dev)
            except np.linalg.LinAlgError:
                U.zero_()
                Tinv.zero_()
                Xinv.zero_()
                kcount = 0
    if reason == 0:
        reason = int(KR.CONVERGED_ITS if ksp.converged_maxits else KR.DIVERGED_ITS)
    return x, its, rnorm, reason, hist, rnorm0


def _basis(A, B, Vm, Yr, U):
    """U + Yr V (the new Ritz vectors into their rows), orthonormalized by
    modified Gram-Schmidt over the rows (a row of norm <= 1e-12 becomes
    zero), with T = U (B A U^T) and X = U U^T on the host."""
    U = axpy(U.reshape(-1), scalar(1.0, U), torch.mm(Yr, Vm).reshape(-1)).view(U.shape)
    rows = []
    for i in range(U.shape[0]):
        u = U[i]
        for c in rows:
            u = axpy(u, -dot(c, u), c)
        nrm = float(norm(u))
        rows.append(u / nrm if nrm > 1e-12 else torch.zeros_like(u))
    U = torch.stack(rows)
    AU = torch.stack([B.mult(A.mult(u.contiguous())) for u in U])
    T = torch.mm(U, AU.t()).cpu().numpy().astype(np.float64)
    X = torch.mm(U, U.t()).cpu().numpy().astype(np.float64)
    return U, T, X
