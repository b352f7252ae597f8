"""DM base: the glue between a grid and the solvers.

Counterpart of ``petsc_tpu/dm/dm.py`` (reference src/dm/interface/dm.c:
DMCreateGlobalVector, DMCreateMatrix, DMCreateInterpolation,
DMCoarsen/DMRefine; the KSP attach of KSPSetDM,
src/ksp/ksp/interface/dmksp.c). It keeps the callback contract (the
compute_operators, compute_rhs and initial-guess callbacks attached to the
DM and called by KSP and PCMG at set-up) and the coarsen/refine hierarchy
that PCMG builds its levels from.
"""

from __future__ import annotations

from ..sys.error import Error
from ..sys.object import PObject


class DM(PObject):
    _class_name = "DM"

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self.app_ctx = None
        self._compute_operators = None
        self._compute_rhs = None
        self._compute_initial_guess = None

    def setAppCtx(self, ctx):
        self.app_ctx = ctx

    def getAppCtx(self):
        return self.app_ctx

    # ---- KSP callback attach (the dmksp.c model) ----

    def setKSPComputeOperators(self, fn):
        self._compute_operators = fn

    def setKSPComputeRHS(self, fn):
        self._compute_rhs = fn

    def createGlobalVector(self):
        raise Error("DM subclass must implement createGlobalVector")

    def createMatrix(self):
        raise Error("DM subclass must implement createMatrix")

    def coarsen(self):
        raise Error("DM subclass must implement coarsen")

    def refine(self):
        raise Error("DM subclass must implement refine")

    def createInterpolation(self, coarse):
        raise Error("DM subclass must implement createInterpolation")
