"""DMStag: staggered structured grids (MAC-scheme layouts).

Counterpart of ``petsc_tpu/dm/stag.py`` (reference src/dm/impls/stag:
DMStagCreate1d/2d/3d, dofs per stratum: vertex/element in 1-D,
vertex/face/element in 2-D, vertex/edge/face/element in 3-D;
DMStagVecGetArray with location-based indexing; DMStagVecSplitToDMDA).

One flat vector, stratum after stratum in the reference's order
(``_stratum_shapes``), each stratum a regular grid; ``getStratumOffsets``
gives every stratum's offset, shape and dof count. Vectors are the port's
``Vec`` on the device; ``getVecArray`` gives a host copy of a stratum, as
DMDA's does.
"""

from __future__ import annotations

import numpy as np

from ..sys.error import Error
from ..vec.vec import Vec
from .dm import DM

# strata per dimension (reference petscdmstag.h DMStagStencilLocation)
_STRATA = {
    1: ("vertex", "element"),
    2: ("vertex", "down_face", "left_face", "element"),
    3: ("vertex", "back_edge", "down_edge", "left_edge",
        "back_face", "down_face", "left_face", "element"),
}

# (name, +1 along each axis, index into the dof tuple), in layout order
_SPECS = {
    1: (("vertex", (1,), 0), ("element", (0,), 1)),
    2: (("vertex", (1, 1), 0), ("left_face", (0, 1), 1), ("down_face", (1, 0), 1),
        ("element", (0, 0), 2)),
    3: (("vertex", (1, 1, 1), 0), ("left_edge", (0, 1, 1), 1), ("down_edge", (1, 0, 1), 1),
        ("back_edge", (1, 1, 0), 1), ("left_face", (1, 0, 0), 2), ("down_face", (0, 1, 0), 2),
        ("back_face", (0, 0, 1), 2), ("element", (0, 0, 0), 3)),
}


class DMStag(DM):
    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self.dim = None
        self.sizes = None       # elements per axis
        self.dof = None         # dofs per stratum, len = dim+1 groups

    @classmethod
    def create(cls, sizes, dof, comm=None):
        """sizes: elements per axis; dof: per-stratum counts, e.g. 2-D
        (dof_vertex, dof_face, dof_element) (DMStagCreate2d)."""
        st = cls(comm)
        st.sizes = tuple(int(s) for s in np.atleast_1d(sizes))
        st.dim = len(st.sizes)
        dof = tuple(int(d) for d in np.atleast_1d(dof))
        if len(dof) != st.dim + 1:
            raise Error(f"DMStag: need {st.dim + 1} stratum dof counts")
        st.dof = dof
        return st

    def _stratum_shapes(self):
        """(name, shape, dof) per stratum with nonzero dof. Vertex grids
        have n+1 points per axis; the reference's plus-one pattern of each
        face and edge stratum; elements have n per axis. Shapes are
        slowest axis first."""
        out = []
        for name, plus, k in _SPECS[self.dim]:
            nd = self.dof[k]
            if nd > 0:
                shape = tuple(self.sizes[ax] + plus[ax] for ax in range(self.dim))[::-1]
                out.append((name, shape, nd))
        return out

    @property
    def N(self):
        return sum(int(np.prod(sh)) * nd for _, sh, nd in self._stratum_shapes())

    def createGlobalVector(self):
        v = Vec(self.comm)
        v.setSizes(self.N)
        v.setUp()
        v._dm = self
        return v

    def getStratumOffsets(self):
        """dict name -> (offset, shape, dof) into the flat vector."""
        out = {}
        off = 0
        for name, sh, nd in self._stratum_shapes():
            out[name] = (off, sh, nd)
            off += int(np.prod(sh)) * nd
        return out

    def _slice(self, location):
        off, sh, nd = self.getStratumOffsets()[location]
        return off, off + int(np.prod(sh)) * nd, sh + ((nd,) if nd > 1 else ())

    def getVecArray(self, vec, location):
        """A host numpy copy (shape + (dof,) where dof > 1) of one stratum."""
        a, b, shape = self._slice(location)
        return vec.array[a:b].detach().cpu().numpy().reshape(shape).copy()

    def setVecArray(self, vec, location, data):
        a, b, _ = self._slice(location)
        arr = vec.array.clone()
        arr[a:b] = vec._like(data).reshape(-1)
        vec.array = arr

    def splitToDMDA(self, vec, location):
        """(DMDA, Vec) for one stratum (DMStagVecSplitToDMDA); the Vec is a
        device copy of the stratum."""
        from .da import DMDA
        a, b, _ = self._slice(location)
        _, sh, nd = self.getStratumOffsets()[location]
        da = DMDA.create(self.dim, tuple(sh[::-1]), dof=max(nd, 1))
        v = da.createGlobalVector()
        v.array = vec.array[a:b].clone()
        return da, v

    def createMatrix(self):
        from ..mat.aij import MatAIJ
        A = MatAIJ(self.comm)
        A.setSizes((self.N, self.N))
        A._dm = self
        return A
