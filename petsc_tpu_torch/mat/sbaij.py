"""MatSBAIJ: symmetric storage, the upper triangle kept on the host.

Counterpart of ``petsc_tpu/mat/sbaij.py`` (reference
src/mat/impls/sbaij/seq/sbaij.c: MatSetValues_SeqSBAIJ folds the lower
triangle, MatMult_SeqSBAIJ applies U + U^T with the diagonal once). As in
the reference, the host keeps the upper triangle (``upper_csr``), and
``assemble`` expands it to the full symmetric CSR U + U^T - D for the
device, so the products run on S2 (or on B1 after ``setBlockSize``). The
``bs`` argument is kept as ``_bs_sym`` only, as the reference keeps it: it
gives the matrix no block size, so the device layout is the bs-1 CSR
until the caller runs ``setBlockSize``. Unlike the reference, the upper
triangle alone is never sent to the device, and a later assembly expands
the upper triangle of the merged CSR (the reference expands the merged
full CSR again, which doubles its off-diagonal entries).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..sys.error import Error
from ..vec.vec import InsertMode
from .aij import MatAIJ


class MatSBAIJ(MatAIJ):
    """Symmetric AIJ: stores and accepts the upper triangle, multiplies as
    the full symmetric operator."""

    def __init__(self, comm=None, bs=1, **kw):
        super().__init__(comm, **kw)
        self._bs_sym = int(bs)
        self.is_symmetric_storage = True
        self._upper = None

    @classmethod
    def create(cls, size, bs=1, comm=None):
        A = cls(comm, bs=bs)
        A.setSizes((size, size) if np.isscalar(size) else size)
        return A

    def setValues(self, rows, cols, values, addv=InsertMode.INSERT_VALUES):
        """Lower-triangle entries are folded to (j, i); under ADD_VALUES only
        the upper copy is kept, so a symmetric element loop that stages
        both (i, j) and (j, i) is not doubled (sbaij.py:41-67)."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        vals = np.asarray(values, dtype=np.float64).reshape(len(rows), len(cols))
        ii = np.repeat(rows, len(cols))
        jj = np.tile(cols, len(rows))
        vv = vals.reshape(-1)
        lower = ii > jj
        ii2 = np.where(lower, jj, ii)
        jj2 = np.where(lower, ii, jj)
        if addv == InsertMode.ADD_VALUES:
            keep = ~lower
            ii2, jj2, vv = ii2[keep], jj2[keep], vv[keep]
        keep2 = (ii2 >= 0) & (jj2 >= 0)
        if self._st_mode is not None and self._st_mode != addv:
            raise Error("cannot mix INSERT_VALUES and ADD_VALUES in one assembly")
        self._st_mode = addv
        self._sti.append(ii2[keep2])
        self._stj.append(jj2[keep2])
        self._stv.append(vv[keep2])

    def setValuesCSR(self, indptr, indices, values):
        """An upper-triangular or a full symmetric CSR (the lower part is
        dropped)."""
        n = len(indptr) - 1
        A = sp.csr_matrix((np.asarray(values, dtype=np.float64),
                           np.asarray(indices, dtype=np.int64),
                           np.asarray(indptr, dtype=np.int64)), shape=(n, n))
        U = sp.triu(A, k=0).tocsr()
        MatAIJ.setValuesCSR(self, U.indptr, U.indices, U.data)

    @classmethod
    def from_scipy(cls, A, comm=None, bs=1):
        M = cls(comm, bs=bs)
        M.setSizes(A.shape)
        U = sp.triu(A.tocsr(), k=0).tocsr()
        MatAIJ.setValuesCSR(M, U.indptr, U.indices, U.data)
        return M.assemble()

    def assemble(self, *a):
        """Merge the staged entries into the upper triangle on the host,
        keep it for ``upper_csr()``, and assemble the full symmetric CSR
        U + U^T - D for the device (sbaij.py:91-106)."""
        self._merge_staged()
        n = self.row_layout.N
        U = sp.triu(sp.csr_matrix((self._vals, self._indices, self._indptr), shape=(n, n)),
                    k=0).tocsr()
        self._upper = (U.indptr.copy(), U.indices.copy(), U.data.copy())
        F = (U + U.T - sp.diags(U.diagonal())).tocsr()
        MatAIJ.setValuesCSR(self, F.indptr, F.indices, F.data)
        return MatAIJ.assemble(self)

    def upper_csr(self):
        """The stored upper triangle (indptr, indices, values)."""
        return self._upper

    def isSymmetric(self, tol=0.0):
        return True
