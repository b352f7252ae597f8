"""DMNetwork: DM over a graph of vertices and edges with per-point
components (circuits, power grids, river/pipe networks).

Counterpart of ``petsc_tpu/dm/network.py`` (reference src/dm/impls/network:
DMNetworkAddSubnetwork, DMNetworkRegisterComponent, DMNetworkAddComponent,
DMNetworkGetEdgeRange/GetVertexRange, DMNetworkGetVariableOffset,
DMNetworkDistribute). The network is host metadata (the edge list, the
component registry and prefix-sum offsets, a Section); a network vector is
one flat device tensor over the dof layout, and ``incidence`` exports the
edges' endpoint offsets so residuals are vectorised scatter-adds (Kirchhoff
laws as one segment sum over edges). ``createMatrix`` builds the
reference's coupling pattern from numpy arrays, not a loop over edges.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..mat.aij import MatAIJ
from ..vec.vec import Vec
from .dm import DM


def _block_pairs(r0, rn, c0, cn):
    """All (row, col) of the dense blocks [r0, r0 + rn) x [c0, c0 + cn),
    one block per entry of the arrays."""
    size = rn * cn
    keep = size > 0
    r0, rn, c0, cn, size = r0[keep], rn[keep], c0[keep], cn[keep], size[keep]
    b = np.repeat(np.arange(len(size)), size)
    k = np.arange(int(size.sum())) - np.repeat(np.cumsum(size) - size, size)
    return r0[b] + k // cn[b], c0[b] + k % cn[b]


class DMNetwork(DM):
    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._components: dict[str, int] = {}   # name -> registered key
        self._edges = None                      # (ne, 2) vertex ids
        self._nv = 0
        self._vcomps: list[list] = []           # per-vertex [(key, ndof)]
        self._ecomps: list[list] = []           # per-edge   [(key, ndof)]
        self._voff = None
        self._eoff = None
        self._ndof = 0

    # ---- topology (networkcreate.c) ----

    @classmethod
    def create(cls, comm=None):
        return cls(comm)

    def registerComponent(self, name, size=0):
        """DMNetworkRegisterComponent: returns the component key."""
        key = len(self._components)
        self._components[name] = key
        return key

    def addSubnetwork(self, name, edges):
        """DMNetworkAddSubnetwork: edge list as (ne, 2) vertex indices."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self._edges = edges if self._edges is None else np.vstack([self._edges, edges])
        self._nv = max(self._nv, int(edges.max()) + 1)
        return self

    def layoutSetUp(self):
        self._vcomps = [[] for _ in range(self._nv)]
        self._ecomps = [[] for _ in range(len(self._edges))]
        return self

    # ---- components / dof layout ----

    def getEdgeRange(self):
        return 0, len(self._edges)

    def getVertexRange(self):
        return 0, self._nv

    def getNumVertices(self):
        return self._nv

    def getNumEdges(self):
        return len(self._edges)

    def addComponent(self, point, key, ndof, is_edge=False):
        """DMNetworkAddComponent: attach (component, ndof) to a point
        (vertex or edge index; is_edge selects the stratum, as in the
        reference)."""
        (self._ecomps if is_edge else self._vcomps)[point].append((key, int(ndof)))
        return self

    def setUp(self):
        """Prefix-sum dof offsets: vertices first, then edges (the
        reference's Section layout)."""
        vd = np.array([sum(nd for _, nd in c) for c in self._vcomps], dtype=np.int64)
        ed = np.array([sum(nd for _, nd in c) for c in self._ecomps], dtype=np.int64)
        self._voff = np.concatenate([[0], np.cumsum(vd)]).astype(np.int64)
        self._eoff = np.concatenate([[0], np.cumsum(ed)]).astype(np.int64) + self._voff[-1]
        self._ndof = int(self._eoff[-1])
        return self

    def getVariableOffset(self, point, is_edge=False):
        return int((self._eoff if is_edge else self._voff)[point])

    def getComponent(self, point, is_edge=False):
        return (self._ecomps if is_edge else self._vcomps)[point]

    # ---- vectors / matrices ----

    def createGlobalVector(self) -> Vec:
        v = Vec(self.comm)
        v.setSizes(self._ndof)
        v.setUp()
        v._dm = self
        return v

    createLocalVector = createGlobalVector

    def createMatrix(self) -> MatAIJ:
        """Matrix with the network coupling pattern (DMCreateMatrix_Network
        preallocation): vertex dofs couple to themselves and across each
        incident edge, edge dofs to their endpoints and themselves."""
        A = MatAIJ(self.comm)
        A.setSizes((self._ndof, self._ndof))
        E = self._edges if self._edges is not None else np.zeros((0, 2), np.int64)
        if len(E):
            vo, vn = self._voff[:-1], np.diff(self._voff)
            eo, en = self._eoff[:-1], np.diff(self._eoff)
            va, vb = E[:, 0], E[:, 1]
            blocks = [(vo[p], vn[p], vo[q], vn[q])
                      for p, q in ((va, va), (va, vb), (vb, va), (vb, vb))]
            for p in (va, vb):
                blocks += [(eo, en, vo[p], vn[p]), (vo[p], vn[p], eo, en)]
            blocks.append((eo, en, eo, en))
            pairs = [_block_pairs(*b) for b in blocks]
            r = np.concatenate([p[0] for p in pairs])
            c = np.concatenate([p[1] for p in pairs])
            if len(r):
                S = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=(self._ndof, self._ndof))
                S.sum_duplicates()
                A.setValuesCSR(S.indptr, S.indices, np.zeros(S.nnz))
                A.assemble()
        A._dm = self
        return A

    # ---- vectorized assembly helpers ----

    def incidence(self):
        """(src_off, dst_off) first-dof offsets of each edge's endpoints:
        feed to vectorised KCL/flow residuals (a segment sum over edges
        replaces the reference's per-vertex FormFunction loops)."""
        return self._voff[self._edges[:, 0]], self._voff[self._edges[:, 1]]

    def distribute(self, overlap=0):
        """DMNetworkDistribute: a no-op on one device."""
        return self
