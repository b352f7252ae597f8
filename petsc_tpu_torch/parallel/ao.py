"""AO: application ordering — a global permutation between the user's
("application") numbering and the framework's ("petsc") numbering.

Counterpart of ``petsc_tpu/parallel/ao.py`` (reference src/vec/is/ao:
AOCreateBasic/AOCreateMemoryScalable, AOApplicationToPetsc,
AOPetscToApplication). Host int64 arrays with vectorised lookups, as the
reference has them (the memory-scalable form's role is moot on one
device)."""

from __future__ import annotations

import numpy as np

from ..sys.object import PObject


class AO(PObject):
    _class_name = "AO"

    def __init__(self, app, petsc=None, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        app = np.asarray(app, dtype=np.int64)
        if petsc is None:
            petsc = np.arange(len(app), dtype=np.int64)
        petsc = np.asarray(petsc, dtype=np.int64)
        n = len(app)
        self._a2p = np.empty(n, dtype=np.int64)
        self._p2a = np.empty(n, dtype=np.int64)
        self._a2p[app] = petsc
        self._p2a[petsc] = app

    @classmethod
    def createBasic(cls, app, petsc=None, comm=None):
        return cls(app, petsc, comm)

    createMemoryScalable = createBasic

    def applicationToPetsc(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        out = np.where(idx >= 0, self._a2p[np.clip(idx, 0, None)], idx)
        if np.isscalar(indices):
            return int(out)
        return out

    def petscToApplication(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        out = np.where(idx >= 0, self._p2a[np.clip(idx, 0, None)], idx)
        if np.isscalar(indices):
            return int(out)
        return out

    def view(self, viewer=None):
        print(f"AO Object: {len(self._a2p)} entries")
