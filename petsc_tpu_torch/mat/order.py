"""MatOrdering: fill- and bandwidth-reducing orderings.

Counterpart of ``petsc_tpu/mat/order.py`` (reference
src/mat/graphops/order: MatGetOrdering; natural, rcm (genrcm.c), nd,
spectral, 1wd, amd/qmd). RCM runs in the port's copy of the native
``rcm`` (:mod:`petsc_tpu_torch.native`; no fallback: a failed build
raises); nd, amd and qmd take SuperLU's permutations through scipy, as
in the reference. All host work on the pattern.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _pattern(A):
    indptr, indices, _ = A.getValuesCSR() if hasattr(A, "getValuesCSR") \
        else (A.indptr, A.indices, None)
    return indptr, indices


def get_ordering(A, kind="rcm"):
    """(rperm, cperm) index arrays (MatGetOrdering; a symmetric ordering
    gives the same array twice)."""
    indptr, indices = _pattern(A)
    n = len(indptr) - 1
    if kind == "natural":
        p = np.arange(n, dtype=np.int64)
        return p, p
    if kind in ("rcm", "1wd", "wd"):
        # one-way dissection is served by RCM, as in the reference
        from .. import native
        p = native.rcm(indptr, indices)
        return p, p
    S = sp.csr_matrix((np.ones(len(indices)), indices, indptr), shape=(n, n))
    if kind == "nd":
        import scipy.sparse.linalg as spla
        lu = spla.splu(S.tocsc() + sp.eye(n), permc_spec="COLAMD")
        return np.asarray(lu.perm_r, dtype=np.int64), np.asarray(lu.perm_c, dtype=np.int64)
    if kind == "spectral":
        # the Fiedler vector of the symmetrized pattern's graph Laplacian
        import scipy.sparse.linalg as spla
        S = ((S + S.T) > 0).astype(np.float64)
        L = sp.diags(np.asarray(S.sum(axis=1)).ravel()) - S
        try:
            _, V = spla.eigsh(L + 1e-8 * sp.eye(n), k=min(2, n - 1), sigma=0, which="LM")
            fied = V[:, -1]
        except Exception:
            fied = np.arange(n, dtype=np.float64)
        p = np.asarray(np.argsort(fied), dtype=np.int64)
        return p, p
    if kind in ("amd", "qmd"):
        import scipy.sparse.linalg as spla
        lu = spla.splu(S.tocsc() + sp.eye(n), permc_spec="MMD_AT_PLUS_A")
        p = np.asarray(lu.perm_c, dtype=np.int64)
        return p, p.copy()
    raise KeyError(f"unknown ordering '{kind}'")


def bandwidth(A):
    """The largest |i - j| over the stored entries."""
    indptr, indices = _pattern(A)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return int(np.abs(np.asarray(indices) - rows).max()) if len(rows) else 0
