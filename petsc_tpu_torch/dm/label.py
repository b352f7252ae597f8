"""DMLabel: integer-valued labels over mesh points + the small glue DMs.

Counterpart of ``petsc_tpu/dm/label.py``, the same host code.

Behavioral reference: src/dm/label (DMLabelSetValue/GetValue/
GetStratumIS/GetValueIS — hash + sorted-array strata), and the glue DMs
DMSliced (src/dm/impls/sliced: a plain block-row layout DM) and DMProduct
(impls/product: tensor product of DMs, used by DMStag internals).
"""

from __future__ import annotations

import numpy as np

from ..vec.vec import Vec
from .dm import DM


class DMLabel:
    """Integer label over points; strata are value -> sorted point ids."""

    def __init__(self, name="label", default=-1):
        self.name = name
        self.default = int(default)
        self._strata: dict[int, set] = {}

    def setValue(self, point, value):
        for s in self._strata.values():
            s.discard(point)
        self._strata.setdefault(int(value), set()).add(int(point))
        return self

    def getValue(self, point):
        for v, s in self._strata.items():
            if point in s:
                return v
        return self.default

    def clearValue(self, point, value=None):
        if value is None:
            for s in self._strata.values():
                s.discard(point)
        else:
            self._strata.get(int(value), set()).discard(point)
        return self

    def insertIS(self, points, value):
        """DMLabelInsertIS: label many points at once."""
        s = self._strata.setdefault(int(value), set())
        s.update(int(p) for p in np.asarray(points).ravel())
        return self

    def getStratumIS(self, value):
        return np.asarray(sorted(self._strata.get(int(value), ())),
                          dtype=np.int64)

    def getStratumSize(self, value):
        return len(self._strata.get(int(value), ()))

    def getValueIS(self):
        """Sorted distinct label values present."""
        return np.asarray(sorted(v for v, s in self._strata.items() if s),
                          dtype=np.int64)

    def getNumValues(self):
        return len(self.getValueIS())

    def stratumHasPoint(self, value, point):
        return point in self._strata.get(int(value), ())


class DMSliced(DM):
    """DMSliced (impls/sliced): unstructured block-row layout — just a dof
    count with a ghost list in the reference; vectors are flat arrays."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self.n = 0
        self.bs = 1

    @classmethod
    def create(cls, bs, n, comm=None):
        d = cls(comm)
        d.bs, d.n = int(bs), int(n)
        return d

    @property
    def N(self):
        return self.n * self.bs

    def createGlobalVector(self) -> Vec:
        v = Vec(self.comm)
        v.setSizes(self.N)
        v.setUp()
        v._dm = self
        return v

    createLocalVector = createGlobalVector


class DMProduct(DM):
    """DMProduct (impls/product): an ordered tuple of sub-DMs (one per
    dimension slot); the reference stores them for DMStag coordinate
    products — the composition logic lives in the consumers."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._dms: list = []

    def setDM(self, slot, dm):
        while len(self._dms) <= slot:
            self._dms.append(None)
        self._dms[slot] = dm
        return self

    def getDM(self, slot):
        return self._dms[slot]
