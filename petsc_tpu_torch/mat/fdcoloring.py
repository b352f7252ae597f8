"""MatFDColoring: finite-difference Jacobians compressed by a colouring.

Counterpart of ``petsc_tpu/mat/fdcoloring.py`` (reference
src/mat/matfd/fdmatrix.c with graphops/color): one residual evaluation
per colour, the differences scattered into the pattern's columns, on the
host. The greedy colouring is the port's copy of the native
``greedy_color`` on S^T S; the other types come from :class:`MatColoring`.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .aij import MatAIJ


class MatFDColoring:
    def __init__(self, pattern: MatAIJ, ctype="greedy"):
        S = pattern.to_scipy()
        self._S = sp.csr_matrix((np.ones_like(S.data), S.indices, S.indptr), shape=S.shape)
        if ctype == "greedy":
            from .. import native
            C = (self._S.T @ self._S).tocsr()
            colors = native.greedy_color(C.indptr, C.indices)
        else:
            from .coloring import MatColoring
            colors = MatColoring(pattern, ctype).apply()
        self.colors = colors
        self.ncolors = int(colors.max()) + 1

    def apply(self, fn, x, f0=None, comm=None):
        """The Jacobian of fn at x as a MatAIJ, from ncolors evaluations of
        fn (numpy in, numpy out); f0 = fn(x) when given."""
        x = np.asarray(x, dtype=np.float64)
        f0 = fn(x) if f0 is None else np.asarray(f0)
        eps = np.sqrt(np.finfo(float).eps)
        Sc = self._S.tocsc()
        data = np.zeros_like(Sc.data)
        for c in range(self.ncolors):
            cols = np.nonzero(self.colors == c)[0]
            h = eps * np.maximum(np.abs(x[cols]), 1.0)
            xp = x.copy()
            xp[cols] += h
            df = fn(xp) - f0
            for ci, col in enumerate(cols):
                lo, hi = Sc.indptr[col], Sc.indptr[col + 1]
                data[lo:hi] = df[Sc.indices[lo:hi]] / h[ci]
        J = sp.csc_matrix((data, Sc.indices, Sc.indptr), shape=Sc.shape).tocsr()
        return MatAIJ.from_scipy(J, comm=comm)
