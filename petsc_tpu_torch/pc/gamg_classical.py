"""Classical (Ruge-Stüben) AMG setup pieces for PCGAMG.

The port's copy of ``petsc_tpu/pc/gamg_classical.py`` (numpy and scipy
only, host set-up), used by :mod:`.gamg` for ``-pc_gamg_type
classical|geo``. Behavioral reference: src/ksp/pc/impls/gamg/classical.c —
PCGAMGCreateGraph_Classical (classical strength: -a_ij > θ·max_k(-a_ik)),
PCGAMGCoarsen_Classical (MIS on the strength graph, strict aggregates;
coarse points = aggregate roots, singletons filtered),
PCGAMGProlongator_Classical_Direct (±-split direct interpolation weights)
and PCGAMGProlongator_Classical_Standard (distance-2 extension through
strong F-neighbors). Host-symbolic phase (vectorized numpy over CSR
triples — the framework's setup side); the resulting P/Ac bind to device
layouts like every other level operator.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def classical_strength(A_sp, theta):
    """Strength graph of PCGAMGCreateGraph_Classical (classical.c:82):
    off-diagonal entries with -a_ij > theta * max_k(-a_ik) (negative
    couplings define classical strength). Returns a CSR carrying the kept
    VALUES (the reference keeps values too), diagonal excluded."""
    A = A_sp.tocsr()
    coo = A.tocoo()
    off = coo.row != coo.col
    neg = np.where(off, -coo.data, 0.0)
    amax = np.zeros(A.shape[0])
    np.maximum.at(amax, coo.row, neg)
    keep = off & (neg > theta * amax[coo.row])
    return sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                         shape=A.shape)


def classical_direct_prolongator(A_sp, coarse, theta):
    """Direct interpolation (classical.c:185 Prolongator_Classical_Direct).

    For a coarse point: P(i, cid(i)) = 1. For a fine point i with
    strong-C neighbors (entries passing the ± threshold tests against
    Amax_pos/Amax_neg): alpha = -a_neg/g_neg, beta = -a_pos/g_pos (0 when
    the strong sum is empty; empty-positive folds a_pos into the
    diagonal), P(i,j) = a_ij * (alpha|beta) / diag. Fully vectorized over
    the CSR triple."""
    A = A_sp.tocsr()
    n = A.shape[0]
    lcid = np.full(n, -1, dtype=np.int64)
    lcid[coarse] = np.arange(len(coarse))
    coo = A.tocoo()
    row, col, val = coo.row, coo.col, coo.data
    off = row != col
    pos = val > 0.0
    amax_pos = np.zeros(n)
    amax_neg = np.zeros(n)
    np.maximum.at(amax_pos, row[off & pos], val[off & pos])
    np.maximum.at(amax_neg, row[off & ~pos], -val[off & ~pos])
    strong = (val > theta * amax_pos[row]) | (-val > theta * amax_neg[row])
    strongC = strong & (lcid[col] >= 0) & off
    g_pos = np.bincount(row, np.where(strongC & pos, val, 0.0),
                        minlength=n)
    g_neg = np.bincount(row, np.where(strongC & ~pos, val, 0.0),
                        minlength=n)
    a_pos = np.bincount(row, np.where(off & pos, val, 0.0), minlength=n)
    a_neg = np.bincount(row, np.where(off & ~pos, val, 0.0), minlength=n)
    diag = A.diagonal().copy()
    diag = np.where(g_pos == 0.0, diag + a_pos, diag)
    alpha = np.where(g_neg == 0.0, 0.0,
                     -a_neg / np.where(g_neg == 0.0, 1.0, g_neg))
    beta = np.where(g_pos == 0.0, 0.0,
                    -a_pos / np.where(g_pos == 0.0, 1.0, g_pos))
    invdiag = np.where(diag == 0.0, 0.0,
                       1.0 / np.where(diag == 0.0, 1.0, diag))
    w = np.where(pos, beta[row], alpha[row]) * invdiag[row] * val
    sel = strongC & (w != 0.0) & (lcid[row] < 0)
    rows = np.concatenate([row[sel], np.asarray(coarse, dtype=np.int64)])
    cols = np.concatenate([lcid[col[sel]], np.arange(len(coarse))])
    vals = np.concatenate([w[sel], np.ones(len(coarse))])
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, len(coarse)))


def geometric_prolongator(A_sp, coarse, coords, theta):
    """Geometric (linearly exact) interpolation — the PCGAMGGeo role
    (src/ksp/pc/impls/gamg/geo.c): each fine point interpolates from its
    strong coarse neighbors with the minimum-norm weights satisfying
    sum w = 1 and sum w (x_c - x_i) = 0, so every linear function is
    reproduced exactly (geo.c's defining property, here by a small
    per-point least-squares instead of a Delaunay triangulation).
    Degenerate neighbor sets (too few / collinear coarse points) fall
    back to the classical direct ±-split row."""
    A = A_sp.tocsr()
    n = A.shape[0]
    coords = np.asarray(coords, dtype=np.float64)
    dim = coords.shape[1]
    lcid = np.full(n, -1, dtype=np.int64)
    lcid[coarse] = np.arange(len(coarse))
    Pd = classical_direct_prolongator(A, coarse, theta).tolil()
    coo = A.tocoo()
    off = coo.row != coo.col
    pos = coo.data > 0.0
    amax_pos = np.zeros(n)
    amax_neg = np.zeros(n)
    np.maximum.at(amax_pos, coo.row[off & pos], coo.data[off & pos])
    np.maximum.at(amax_neg, coo.row[off & ~pos], -coo.data[off & ~pos])
    for i in range(n):
        if lcid[i] >= 0:
            continue
        sl = slice(A.indptr[i], A.indptr[i + 1])
        cols = A.indices[sl]
        vals = A.data[sl]
        strong = ((vals > theta * amax_pos[i])
                  | (-vals > theta * amax_neg[i])) & (lcid[cols] >= 0) \
            & (cols != i)
        nbrs = cols[strong]
        m = len(nbrs)
        if m < dim + 1:
            continue                      # keep the direct fallback row
        M = np.vstack([np.ones((1, m)),
                       (coords[nbrs] - coords[i]).T])   # (d+1, m)
        rhs = np.zeros(dim + 1)
        rhs[0] = 1.0
        w, res, rank, _ = np.linalg.lstsq(M, rhs, rcond=None)
        if rank < dim + 1 or np.abs(M @ w - rhs).max() > 1e-10:
            continue                      # degenerate: fallback
        Pd.rows[i] = [int(c) for c in lcid[nbrs]]
        Pd.data[i] = [float(v) for v in w]
    return Pd.tocsr()


def classical_standard_prolongator(A_sp, coarse, theta):
    """Standard interpolation (classical.c:549): extend the stencil of a
    fine point through its strong F-neighbors (one distance-2 hop of the
    local part: row_i <- a_ii e_i + sum_{strong F j} a_ij * row_j / a_jj
    eliminated), then apply the direct ±-split weights to the extended
    row. Implemented as the sparse elimination A_ext = A - S_F D^{-1} A
    restricted to F columns, followed by direct interpolation on the
    extended rows."""
    A = A_sp.tocsr()
    n = A.shape[0]
    lcid = np.full(n, -1, dtype=np.int64)
    lcid[coarse] = np.arange(len(coarse))
    coo = A.tocoo()
    row, col, val = coo.row, coo.col, coo.data
    off = row != col
    pos = val > 0.0
    amax_pos = np.zeros(n)
    amax_neg = np.zeros(n)
    np.maximum.at(amax_pos, row[off & pos], val[off & pos])
    np.maximum.at(amax_neg, row[off & ~pos], -val[off & ~pos])
    strong = (val > theta * amax_pos[row]) | (-val > theta * amax_neg[row])
    # strong F-F connections: eliminate them through the neighbor's row
    sFF = strong & off & (lcid[col] < 0) & (lcid[row] < 0)
    SF = sp.csr_matrix((val[sFF], (row[sFF], col[sFF])), shape=A.shape)
    d = A.diagonal()
    dinv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    Aext = (A - SF @ sp.diags(dinv) @ A).tocsr()
    Aext.eliminate_zeros()
    return classical_direct_prolongator(Aext, coarse, theta)
