"""MatColoring: graph colourings of a matrix pattern.

Counterpart of ``petsc_tpu/mat/coloring.py`` (reference
src/mat/graphops/color: jp.c, greedy.c, power.c, and the SL/LF/ID
orderings of color.c). Colourings are distance 2 by default, on the
column-intersection graph (MatFDColoring's compression); ``setDistance(1)``
colours the pattern's own graph. Host set-up work, as in the reference.
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp

from ..sys.error import Error


def _column_graph(S):
    """Distance-2 adjacency: columns that share a row (S^T S, no diagonal)."""
    P = sp.csr_matrix((np.ones_like(S.data), S.indices, S.indptr), shape=S.shape)
    C = (P.T @ P).tocsr()
    C.setdiag(0)
    C.eliminate_zeros()
    return C


def greedy_color(C, order=None):
    """Sequential greedy colouring of adjacency C in the given order
    (greedy.c)."""
    n = C.shape[0]
    order = np.arange(n) if order is None else np.asarray(order)
    colors = np.full(n, -1, dtype=np.int64)
    for v in order:
        nbr = C.indices[C.indptr[v]:C.indptr[v + 1]]
        used = set(int(c) for c in colors[nbr] if c >= 0)
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def jp_color(C, seed=0):
    """Jones-Plassmann (jp.c): random priorities; each round the uncoloured
    vertices that beat every uncoloured neighbour take their smallest free
    colour together, in whole-graph vectorized rounds."""
    n = C.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    w = np.random.default_rng(seed).permutation(n)
    colors = np.full(n, -1, dtype=np.int64)
    indptr, indices = C.indptr, C.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))
    while (colors < 0).any():
        unc = colors < 0
        wn = np.where(unc[indices], w[indices], -1)
        nbr_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(nbr_max, rows, wn)
        winners = unc & (w > nbr_max)
        if not winners.any():      # isolated leftovers (no uncoloured neighbours)
            winners = unc
        active = winners.copy()
        c = 0
        while active.any():
            has_c = np.zeros(n, dtype=bool)
            sel = colors[indices] == c
            if sel.any():
                has_c[rows[sel]] = True
            take = active & ~has_c
            colors[take] = c
            active &= ~take
            c += 1
    return colors


def power_graph(S, k):
    """The pattern of C^k for MATCOLORINGPOWER (power.c)."""
    C = _column_graph(S)
    B = sp.csr_matrix((np.ones_like(C.data), C.indices, C.indptr), shape=C.shape)
    G = B.copy()
    for _ in range(k - 1):
        G = ((G @ B) + B).tocsr()
    G.setdiag(0)
    G.eliminate_zeros()
    return G


class MatColoring:
    """MatColoringCreate/SetType/Apply (color.c): per-column colours as one
    int array (the ISColoring's role)."""

    TYPES = ("jp", "greedy", "natural", "sl", "lf", "id", "power")

    def __init__(self, mat=None, ctype="greedy"):
        self.mat = mat
        self.ctype = ctype
        self.dist = 2
        self.power_k = 2

    @classmethod
    def create(cls, mat=None):
        return cls(mat)

    def setType(self, t):
        if t not in self.TYPES:
            raise Error(f"unknown MatColoring type {t}")
        self.ctype = t
        return self

    def setDistance(self, d):
        self.dist = int(d)
        return self

    def _graph(self, S):
        return _column_graph(S) if self.dist == 2 else _strip_diag(S)

    def apply(self, mat=None):
        S = (mat if mat is not None else self.mat).to_scipy().tocsr()
        if self.ctype == "natural":
            return np.arange(S.shape[1], dtype=np.int64)
        if self.ctype == "power":
            return greedy_color(power_graph(S, self.power_k))
        C = self._graph(S)
        if self.ctype == "jp":
            return jp_color(C)
        deg = np.diff(C.indptr)
        if self.ctype == "lf":       # largest first
            return greedy_color(C, np.argsort(-deg, kind="stable"))
        if self.ctype == "id":       # incidence degree: ascending degree
            return greedy_color(C, np.argsort(deg, kind="stable"))
        if self.ctype == "sl":       # smallest last
            return greedy_color(C, _smallest_last_order(C))
        return greedy_color(C)

    def validate(self, colors, mat=None):
        """No two adjacent (distance-dist) columns share a colour."""
        C = self._graph((mat if mat is not None else self.mat).to_scipy().tocsr())
        rows = np.repeat(np.arange(C.shape[0]), np.diff(C.indptr))
        return bool(np.all(colors[rows] != colors[C.indices]))


def _strip_diag(S):
    """Distance-1 adjacency: the pattern without self-loops."""
    C = sp.csr_matrix(S, copy=True)
    C.setdiag(0)
    C.eliminate_zeros()
    return C


def _smallest_last_order(C):
    """Smallest-last ordering (Matula-Beck): remove a vertex of least
    degree again and again; colour in the reverse order of removal."""
    n = C.shape[0]
    deg = np.diff(C.indptr).astype(np.int64).copy()
    removed = np.zeros(n, dtype=bool)
    order = np.zeros(n, dtype=np.int64)
    heap = [(int(d), v) for v, d in enumerate(deg)]
    heapq.heapify(heap)
    k = n - 1
    while heap:
        d, v = heapq.heappop(heap)
        if removed[v] or d != deg[v]:
            continue
        removed[v] = True
        order[k] = v
        k -= 1
        nbr = C.indices[C.indptr[v]:C.indptr[v + 1]]
        for u in nbr[~removed[nbr]]:
            deg[u] -= 1
            heapq.heappush(heap, (int(deg[u]), int(u)))
    return order
