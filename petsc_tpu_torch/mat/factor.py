"""Factorizations on the host: ILU(0), ILU(k), ICC(0), sparse LU and ILUdt.

Counterpart of ``petsc_tpu/mat/factor.py`` (reference
MatILUFactorSymbolic_SeqAIJ aijfact.c:1536, MatLUFactorNumeric_SeqAIJ
aijfact.c:216). The factorization is the host set-up phase, on the port's
native library (:mod:`petsc_tpu_torch.native`); the solves are the
level-scheduled sweeps of :mod:`petsc_tpu_torch.ops.trisolve` on the
device. Full LU with fill and the drop-tolerance ILU use scipy's SuperLU as
the factor engine (PETSc's MatGetFactor external-solver pattern).

Every function returns the factors as (L_strict, U_strict, dinv), each
CSR a triple (indptr, indices, values) of numpy arrays, with
A ≈ (I + L) (D + U) and dinv = 1 / diag(D); the SuperLU ones add the
row and column permutations.
"""

from __future__ import annotations

import numpy as np

from .. import native


def ilu0(indptr, indices, vals):
    """In-pattern incomplete LU, natural ordering, no shift (rows
    column-sorted, every diagonal present). A zero pivot or a missing
    diagonal raises Error (the native factorization checks each row)."""
    m = len(indptr) - 1
    a = native.ilu0_inplace(np.asarray(indptr, dtype=np.int64),
                            np.asarray(indices, dtype=np.int64), vals)
    Li, Lj, Lv, Ui, Uj, Uv = _split_lu(indptr, indices, a, m)
    rows = np.repeat(np.arange(m), np.diff(indptr))
    d = a[np.asarray(indices) == rows]
    return (Li, Lj, Lv), (Ui, Uj, Uv), 1.0 / d


def iluk(indptr, indices, vals, k):
    """ILU(k): the native level-of-fill pattern (aijfact.c:1536's role),
    then the in-pattern numeric factorization on that pattern, the fill
    slots starting at zero."""
    if k <= 0:
        return ilu0(indptr, indices, vals)
    ip2, ix2 = native.iluk_symbolic(np.asarray(indptr, dtype=np.int64),
                                    np.asarray(indices, dtype=np.int64), k)
    m = len(indptr) - 1
    # rows of both patterns are column-sorted: each original entry's slot
    # in the extended pattern comes from a per-row searchsorted
    ext_vals = np.zeros(len(ix2))
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    for i in range(m):
        lo, hi = indptr[i], indptr[i + 1]
        elo, ehi = ip2[i], ip2[i + 1]
        pos = elo + np.searchsorted(ix2[elo:ehi], indices[lo:hi])
        ext_vals[pos] = vals[lo:hi]
    return ilu0(ip2, ix2, ext_vals)


def _split_lu(indptr, indices, a, m):
    """The strictly lower and strictly upper parts of a CSR with values a."""
    indices = np.asarray(indices)
    rows = np.repeat(np.arange(m), np.diff(indptr))
    lower = indices < rows
    upper = indices > rows
    Li = np.zeros(m + 1, dtype=np.int64)
    np.add.at(Li, rows[lower] + 1, 1)
    Li = np.cumsum(Li)
    Ui = np.zeros(m + 1, dtype=np.int64)
    np.add.at(Ui, rows[upper] + 1, 1)
    Ui = np.cumsum(Ui)
    return Li, indices[lower], a[lower], Ui, indices[upper], a[upper]


def _superlu_triples(lu):
    import scipy.sparse as sp
    L = lu.L.tocsr()          # unit lower, diagonal included
    U = lu.U.tocsr()          # upper, diagonal included
    d = U.diagonal()
    Ls = sp.tril(L, k=-1).tocsr()
    Us = sp.triu(U, k=1).tocsr()
    return ((Ls.indptr, Ls.indices, Ls.data), (Us.indptr, Us.indices, Us.data),
            1.0 / d, lu.perm_r, lu.perm_c)


def splu_factors(A_scipy):
    """Sparse LU with fill by SuperLU (COLAMD column order): (L_strict,
    U_strict, dinv, perm_r, perm_c) with A = Pr^T (I + L)(D + U) Pc^T."""
    import scipy.sparse.linalg as spla
    return _superlu_triples(spla.splu(A_scipy.tocsc(), permc_spec="COLAMD",
                                      options=dict(SymmetricMode=False)))


def spilu_factors(A_scipy, drop_tol=1e-4, fill_factor=10.0):
    """Incomplete LU with a drop tolerance (the ILUdt that PETSc reaches
    through -pc_factor_drop_tolerance): SuperLU's ILU keeps the entries
    above drop_tol up to fill_factor times the fill; applied by the same
    permuted sweeps as the full LU."""
    import scipy.sparse.linalg as spla
    return _superlu_triples(spla.spilu(A_scipy.tocsc(), drop_tol=float(drop_tol),
                                       fill_factor=float(fill_factor)))


def icc0(indptr, indices, vals):
    """ICC(0) as ILU(0) on the symmetric pattern: factors usable as
    L D L^T. For SPD inputs this equals PETSc's ICC(0) up to roundoff."""
    return ilu0(indptr, indices, vals)
