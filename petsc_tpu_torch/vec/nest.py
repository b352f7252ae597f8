"""VecNest: a vector of sub-vectors (src/vec/vec/impls/nest), the
fieldsplit companion.

Counterpart of ``petsc_tpu/vec/nest.py``: the sub-vectors with a flat
view, their global arrays concatenated (gathered from every rank and
split again on a multi-rank comm, as ``getArray`` and ``setArray`` do).
"""

from __future__ import annotations

import numpy as np

from .vec import Vec


class VecNest(Vec):
    def __init__(self, subvecs, comm=None, **kw):
        super().__init__(comm, **kw)
        self._subs = list(subvecs)
        self.setSizes(sum(v.getSize() for v in self._subs))
        self.setUp()
        self._refresh()

    @classmethod
    def create(cls, subvecs, comm=None):
        return cls(subvecs, comm)

    def _refresh(self):
        self.setArray(np.concatenate([np.asarray(v.getArray()) for v in self._subs]))

    def getNestSize(self):
        return len(self._subs)

    def getNestSubVecs(self):
        """The sub-vectors, refreshed from the flat storage."""
        arr = np.asarray(self.getArray())
        off = 0
        for v in self._subs:
            n = v.getSize()
            v.setArray(arr[off:off + n])
            off += n
        return self._subs

    def setNestSubVecs(self, subvecs):
        self._subs = list(subvecs)
        self._refresh()
