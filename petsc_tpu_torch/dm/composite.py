"""DMComposite / DMShell / DMRedundant: multi-physics glue DMs.

Counterpart of ``petsc_tpu/dm/composite.py`` (reference
src/dm/impls/composite: DMCompositeCreate/AddDM, the global vector as the
packed concatenation, Scatter/Gather to sub-vectors, DMCreateFieldIS for
fieldsplit; impls/shell, the user-hook DM; impls/redundant, n dofs on
every rank, which on one device is a plain n-vector). Vectors are the
port's ``Vec`` on the device; the sub-vectors of ``getAccess`` are device
copies of the packed slices, written back by ``restoreAccess``.
"""

from __future__ import annotations

import numpy as np

from ..sys.error import Error
from ..vec.vec import Vec
from .dm import DM


def _new_vec(dm, n):
    v = Vec(dm.comm)
    v.setSizes(n)
    v.setUp()
    v._dm = dm
    return v


def _new_mat(dm, n):
    from ..mat.aij import MatAIJ
    A = MatAIJ(dm.comm)
    A.setSizes((n, n))
    A._dm = dm
    return A


class DMComposite(DM):
    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self.dms: list[DM] = []

    @classmethod
    def create(cls, dms=(), comm=None):
        dmc = cls(comm)
        for d in dms:
            dmc.addDM(d)
        return dmc

    def addDM(self, dm):
        self.dms.append(dm)
        return self

    def getNumberDM(self):
        return len(self.dms)

    @property
    def N(self):
        return sum(d.N for d in self.dms)

    def _offsets(self):
        sizes = [d.N for d in self.dms]
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64), sizes

    def createGlobalVector(self):
        return _new_vec(self, self.N)

    def getAccess(self, vec):
        """Sub-vectors of the packed global vector (copies on its device;
        restoreAccess writes them back)."""
        offs, _ = self._offsets()
        a = vec.array
        return [Vec.from_array(a[offs[i]:offs[i + 1]], comm=self.comm)
                for i in range(len(self.dms))]

    def restoreAccess(self, vec, subvecs):
        offs, _ = self._offsets()
        a = vec.array.clone()
        for i, sv in enumerate(subvecs):
            a[offs[i]:offs[i + 1]] = sv.array.to(a.device, a.dtype)
        vec.array = a

    def getFieldIS(self):
        """Index sets of each packed field (DMCreateFieldDecomposition):
        feed these to PCFieldSplit.setIS."""
        from ..parallel.index import IS
        offs, _ = self._offsets()
        return [IS(np.arange(offs[i], offs[i + 1]), self.comm)
                for i in range(len(self.dms))]

    def createMatrix(self):
        return _new_mat(self, self.N)


class DMShell(DM):
    """User-hook DM (impls/shell): supply vector/matrix constructors."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._create_global = None
        self._create_matrix = None

    def setCreateGlobalVector(self, fn):
        self._create_global = fn

    def setCreateMatrix(self, fn):
        self._create_matrix = fn

    def createGlobalVector(self):
        if self._create_global is None:
            raise Error("DMShell: setCreateGlobalVector first")
        v = self._create_global(self)
        v._dm = self
        return v

    def createMatrix(self):
        if self._create_matrix is None:
            raise Error("DMShell: setCreateMatrix first")
        A = self._create_matrix(self)
        A._dm = self
        return A


class DMRedundant(DM):
    """n dofs 'replicated on every rank' (impls/redundant): a plain
    n-vector on one device."""

    def __init__(self, n=0, comm=None, **kw):
        super().__init__(comm, **kw)
        self.n = int(n)

    @classmethod
    def create(cls, n, comm=None):
        return cls(n, comm)

    @property
    def N(self):
        return self.n

    def createGlobalVector(self):
        return _new_vec(self, self.n)

    def createMatrix(self):
        return _new_mat(self, self.n)
