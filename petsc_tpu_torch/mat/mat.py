"""Mat base class.

Counterpart of the ``Mat`` base of ``petsc_tpu/mat/mat.py`` (reference
src/mat/interface/matrix.c — MatMult :2696): the petsc4py-style AIJ
factories, sizes, the (meta, data) contract bound through
``ops.operator.bind``, mult, transpose mult, diagonal, vector creation
and ``getFactor``.
"""

from __future__ import annotations

from .. import config
from ..ops import operator
from ..parallel.layout import Layout
from ..parallel.mesh import Comm, comm_self
from ..sys.object import PObject
from ..vec.vec import Vec


class Mat(PObject):
    _class_name = "Mat"

    def __init__(self, comm: Comm | None = None, **kw):
        super().__init__(**kw)
        self.comm = comm or comm_self()
        self.row_layout: Layout | None = None
        self.col_layout: Layout | None = None
        self.symmetric = None

    # ---------------- factories (petsc4py-style) ----------------

    @staticmethod
    def createAIJ(size, csr=None, coo=None, comm=None, bs=1):
        """An assembled MatAIJ from a CSR triple (indptr, indices, values)
        or COO triplets (i, j, v); without either, an empty one to fill."""
        from .aij import MatAIJ
        A = MatAIJ(comm)
        A.setSizes(size, bs=bs)
        if csr is not None:
            A.setValuesCSR(*csr)
            A.assemble()
        elif coo is not None:
            i, j, v = coo
            A.setPreallocationCOO(i, j)
            A.setValuesCOO(v)
        return A

    @staticmethod
    def createAIJWithArrays(size, csr, comm=None):
        return Mat.createAIJ(size, csr=csr, comm=comm)

    # ---------------- sizes ----------------

    def setSizes(self, size, bs: int = 1):
        m, n = size if isinstance(size, tuple) else (size, size)
        self.row_layout = Layout(int(m), bs=bs, axis=self.comm.axis)
        self.col_layout = Layout(int(n), bs=bs, axis=self.comm.axis)
        return self

    def getSize(self):
        return (self.row_layout.N, self.col_layout.N)

    def getLocalSize(self):
        return (self.row_layout.block, self.col_layout.block)

    def getOwnershipRange(self):
        return (0, self.row_layout.N)

    @property
    def shape(self):
        return self.getSize()

    # ---------------- the (meta, data) contract ----------------

    @property
    def meta(self) -> tuple:
        raise NotImplementedError

    def device_data(self):
        raise NotImplementedError

    def op(self) -> operator.Op:
        return operator.bind(self.meta, self.device_data())

    # ---------------- apply ----------------

    def mult(self, x: Vec, y: Vec):
        """y <- A x (matrix.c:2696)."""
        y.array = self.op().mult(x.array)
        config.log().log_flops("MatMult", 2 * self.nnz() if hasattr(self, "nnz") else 0)
        return y

    def multTranspose(self, x: Vec, y: Vec):
        op = self.op()
        if op.mult_t is None:
            raise NotImplementedError(f"{type(self).__name__} has no transpose apply")
        y.array = op.mult_t(x.array)
        return y

    def getDiagonal(self, d: Vec | None = None) -> Vec:
        op = self.op()
        if op.diag is None:
            raise NotImplementedError
        if d is None:
            d = self.createVecLeft()
        dv = op.diag()
        # constant-stencil operators carry a scalar diagonal; either way d
        # gets its own copy, never the operator's cached tensor
        d.array = dv.expand(d.array.shape[0]).clone()
        return d

    # ---------------- vectors ----------------

    def createVecs(self):
        return self.createVecRight(), self.createVecLeft()

    def createVecRight(self) -> Vec:
        v = Vec(self.comm)
        v.setLayout(self.col_layout)
        v.setUp()
        return v

    def createVecLeft(self) -> Vec:
        v = Vec(self.comm)
        v.setLayout(self.row_layout)
        v.setUp()
        return v

    def getFactor(self, solver_type="petsc", factor_kind="lu"):
        """MatGetFactor (matrix.c): the built-in backend's lu, ilu,
        cholesky or icc (host factors, device sweeps)."""
        from .factorctx import FactorContext
        return FactorContext(self, solver_type, factor_kind)

    def setOption(self, name, flag=True):
        if name in ("symmetric", "spd"):
            self.symmetric = bool(flag)

    def view(self, viewer=None):
        m, n = self.getSize()
        print(f"Mat Object: type: {type(self).__name__.lower()}")
        print(f"  rows={m}, cols={n}")


__all__ = ["Mat"]
