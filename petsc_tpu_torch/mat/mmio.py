"""MatrixMarket interop (reference src/mat/tests/mmloader.c and the
bench_spmv.c SuiteSparse workflow): load .mtx files as MatAIJ.

Counterpart of ``petsc_tpu/mat/mmio.py``."""

from __future__ import annotations


def load_matrix_market(path, comm=None):
    import scipy.io
    import scipy.sparse as sp
    from .aij import MatAIJ
    A = scipy.io.mmread(path)
    if not sp.issparse(A):
        A = sp.csr_matrix(A)
    return MatAIJ.from_scipy(A.tocsr(), comm=comm)


def save_matrix_market(path, A):
    import scipy.io
    scipy.io.mmwrite(path, A.to_scipy())
