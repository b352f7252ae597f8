"""FactorContext: the MatGetFactor / MatLUFactorSymbolic / Numeric /
MatSolve surface (reference src/mat/interface/matrix.c factor paths).

Counterpart of ``petsc_tpu/mat/factorctx.py``: the factorization is the
host one of :mod:`.factor`, the solve the level-scheduled sweeps of
:mod:`petsc_tpu_torch.ops.trisolve` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import trisolve
from ..ops.gather_kernels import gather
from ..sys.error import Error
from . import factor


class FactorContext:
    def __init__(self, A, solver_type="petsc", kind="lu"):
        if solver_type not in ("petsc",):
            raise Error(f"MatSolverType '{solver_type}' not available; "
                        "built-in 'petsc' backend covers lu/ilu/cholesky/icc")
        self.A = A
        self.kind = kind
        self._data = None

    def factorSymbolic(self, *a, **kw):
        return self  # the symbolic phase is folded into the numeric one (host)

    def factorNumeric(self, *a, **kw):
        indptr, indices, vals = self.A.getValuesCSR()
        if self.kind in ("ilu", "icc"):
            _, self._data = trisolve.make_trisolve_plan(*factor.ilu0(indptr, indices, vals))
            self._perm = None
        elif self.kind in ("lu", "cholesky"):
            L, U, dinv, pr, pc = factor.splu_factors(self.A.to_scipy())
            _, self._data = trisolve.make_trisolve_plan(L, U, dinv)
            dev = config.device()
            self._perm = (torch.as_tensor(np.argsort(pr).astype(np.int32), device=dev),
                          torch.as_tensor(np.asarray(pc).astype(np.int32), device=dev))
        else:
            raise Error(f"factor kind {self.kind}")
        return self

    def solve(self, b, x=None):
        """x = A^{-1} b (or the incomplete factors' inverse) for a Vec or a
        tensor b; returns x (a new Vec when x is None)."""
        from ..vec.vec import Vec
        if self._data is None:
            self.factorNumeric()
        barr = b.array if isinstance(b, Vec) else torch.as_tensor(b, device=config.device())
        if self._perm is not None:
            iperm_r, perm_c = self._perm
            out = gather(trisolve.trisolve_apply(self._data, gather(barr, iperm_r, check=False)),
                         perm_c, check=False)
        else:
            out = trisolve.trisolve_apply(self._data, barr)
        if x is None:
            return Vec.from_array(out, comm=self.A.comm)
        x.array = out
        return x
