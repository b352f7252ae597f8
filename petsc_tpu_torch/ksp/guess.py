"""KSPGuess: an initial guess predicted from earlier solves.

Counterpart of ``petsc_tpu/ksp/guess.py`` (reference
src/ksp/ksp/guess/impls/{fischer,pod}, KSPGuess petscksp.h:1120-1129).
Fischer (model 1) keeps up to `size` pairs (x_i, A x_i) with the A x basis
orthonormalized (modified Gram-Schmidt) and guesses x0 = sum <b, q_i> xhat_i;
POD keeps the last `size` solutions, takes the basis Phi of their span and
guesses the Galerkin x0 = Phi (Phi^T A Phi)^{-1} Phi^T b, with A Phi from
the products cached per snapshot (one product per update).

The stored vectors stay on the operator's device as (size, n) blocks: the
projections with a block run on ``torch.mv``, as GMRES's basis products do,
the dots on K4 and the updates on K2 (:mod:`.common`). Only small dense
work comes to the host, in float64: Fischer's norms, and POD's m x m Gram
matrices X^T X and X^T A X (kept up to date with one block product each
per update), their eigen-decomposition and the k x k Galerkin system. The
eigenvectors V and values s^2 of X^T X give the thin SVD's basis, Phi =
X V / s, as the reference's ``np.linalg.svd`` of X does.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import axpy, dot, host, norm


class KSPGuess:
    def __init__(self, ksp, kind="fischer", size=10):
        self.ksp = ksp
        self.kind = kind
        self.size = size
        self.reset()

    def reset(self):
        self._Q = None     # fischer: the orthonormalized A x basis, (size, n)
        self._X = None     # fischer: the matching combinations of solutions
        self._S = None     # pod: the solution window, (size, n)
        self._AS = None    # pod: A times each snapshot
        self._n = 0        # the rows in use: the first _n of each block
        self._head = 0     # once all are in use, the oldest (replaced next)
        self._G = None     # pod: X^T X and X^T A X by row, on the host
        self._H = None
        self._coef = None  # pod: Phi = X^T coef, (n, k), on the host
        self._red = None   # pod: Phi^T A Phi (k, k)

    def _order(self):
        """The rows in use, oldest first."""
        return [(self._head + i) % self.size for i in range(self._n)]

    def _slot(self, like):
        """The row for a new vector: a free one, else the oldest, dropped."""
        if self._Q is None and self._S is None:
            blk = torch.zeros((self.size, like.numel()), dtype=like.dtype, device=like.device)
            if self.kind == "pod":
                self._S, self._AS = blk, blk.clone()
                self._G, self._H = np.zeros((self.size,) * 2), np.zeros((self.size,) * 2)
            else:
                self._Q, self._X = blk, blk.clone()
        if self._n < self.size:
            self._n += 1
            return self._n - 1
        slot, self._head = self._head, (self._head + 1) % self.size
        return slot

    def formGuess(self, b):
        """x0 from the stored space as a tensor like b, or None when empty."""
        n = self._n
        if n == 0:
            return None
        if self.kind == "pod":
            rhs = self._coef.T @ torch.mv(self._S[:n], b).double().cpu().numpy()
            try:
                y = np.linalg.solve(self._red, rhs)
            except np.linalg.LinAlgError:
                y, *_ = np.linalg.lstsq(self._red, rhs, rcond=None)
            c = torch.as_tensor(self._coef @ y, dtype=b.dtype, device=b.device)
            return torch.mv(self._S[:n].t(), c)
        return torch.mv(self._X[:n].t(), torch.mv(self._Q[:n], b))

    def _apply_A(self, v):
        return self.ksp.mat.op().mult(v)

    def update(self, x, b):
        """Store a converged pair (KSPGuessUpdate)."""
        if self.kind == "pod":
            self._update_pod(x)
            return
        ax = self._apply_A(x)
        xh, q = x, ax
        if self._n:
            for i in self._order():
                h = -dot(self._Q[i], q)
                q = axpy(q, h, self._Q[i])
                xh = axpy(xh, h, self._X[i])
        nrm, nrm_ax = host(norm(q), norm(ax))
        if nrm < 1e-12 * max(nrm_ax, 1e-300):
            return
        slot = self._slot(x)
        torch.div(q, nrm, out=self._Q[slot])
        torch.div(xh, nrm, out=self._X[slot])

    def _update_pod(self, x):
        slot = self._slot(x)
        n = self._n
        self._S[slot] = x
        self._AS[slot] = self._apply_A(x)
        # the new row and column of X^T X and X^T A X (H[i, j] = s_i . A s_j):
        # x against every stored snapshot and its product, in one transfer
        xs, xas, asx = torch.stack([torch.mv(self._S[:n], x), torch.mv(self._AS[:n], x),
                                    torch.mv(self._S[:n], self._AS[slot])]).double().cpu().numpy()
        G, H = self._G[:n, :n], self._H[:n, :n]
        G[slot, :], G[:, slot] = xs, xs
        H[slot, :], H[:, slot] = xas, asx
        # Phi = X V / s from X^T X = V s^2 V^T. Its eigenvalues are exact only
        # to about eps times the largest, so a singular value under 1e-7 of
        # the largest is rounding (the reference cuts the SVD's at 1e-10)
        lam, V = np.linalg.eigh(G)
        lam, V = lam[::-1], V[:, ::-1]
        s = np.sqrt(np.maximum(lam, 0.0))
        k = max(int(np.sum(s > 1e-7 * max(s[0], 1e-300))), 1)
        self._coef = V[:, :k] / s[:k]
        self._red = self._coef.T @ H @ self._coef
