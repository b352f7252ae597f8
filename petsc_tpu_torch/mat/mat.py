"""Mat base class.

Counterpart of the ``Mat`` base of ``petsc_tpu/mat/mat.py`` (reference
src/mat/interface/matrix.c — MatMult :2696): the petsc4py-style AIJ
factories, sizes, the (meta, data) contract bound through
``ops.operator.bind``, mult, multAdd, transpose mult, diagonal, vector
creation, the block size (``setSizes(bs)``, ``setBlockSize``, which
re-lays an assembled matrix on the device), the (near-)nullspace slots
GAMG reads, ``getFactor``, and ``MatNullSpace`` with the rigid-body modes
(mat.py:336-383); the matrix-free ``MatShell`` and the ``MatDense`` of
mat.py:252-335, with the ``createDense``, ``createShell`` and
``createStencil`` factories (mat.py:69-116).
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from .. import config
from ..ops import operator
from ..parallel.layout import Layout
from ..parallel.mesh import Comm, comm_self
from ..sys.object import PObject
from ..vec.vec import NormType, Vec


class MatStructure(IntEnum):  # include/petscmat.h MatStructure
    DIFFERENT_NONZERO_PATTERN = 0
    SUBSET_NONZERO_PATTERN = 1
    SAME_NONZERO_PATTERN = 2
    UNKNOWN_NONZERO_PATTERN = 3


class Mat(PObject):
    _class_name = "Mat"

    def __init__(self, comm: Comm | None = None, **kw):
        super().__init__(**kw)
        self.comm = comm or comm_self()
        self.row_layout: Layout | None = None
        self.col_layout: Layout | None = None
        self._assembled = False
        self.nullspace = None       # MatNullSpace analog
        self.near_nullspace = None  # what GAMG's tentative prolongator takes
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

    @staticmethod
    def createDense(size, array=None, comm=None):
        A = MatDense(comm)
        A.setSizes(size)
        if array is not None:
            A.setDenseArray(array)
        return A

    @staticmethod
    def createShell(size, mult, mult_transpose=None, diag=None, context=None, comm=None):
        """A matrix-free operator: ``mult(x)`` on tensors, or ``mult(context,
        x)`` when a context is given; ``diag()`` gives the diagonal."""
        A = MatShell(comm)
        A.setSizes(size)
        A.setShellOperations(mult, mult_transpose, diag, context)
        return A

    @staticmethod
    def createStencil(grid, offsets, coeffs, comm=None):
        """A grid-stencil matrix from per-offset coefficient arrays (DMDA's
        fdda.c matrices): grid = (..., ny, nx), offsets = [(dz, dy, dx), ...],
        coeffs of shape (K,) + grid, x fastest. Couplings that leave the
        grid must already be zero in coeffs; zero coefficients are not
        stored. The grid is declared before the one device build, so a
        pattern that decomposes into the offsets takes ``aij_dnd``."""
        import scipy.sparse as sp
        from .aij import MatAIJ
        grid = tuple(int(g) for g in grid)
        N = int(np.prod(grid))
        idx = np.arange(N)
        multi = np.stack(np.unravel_index(idx, grid), axis=1)
        rows_l, cols_l, vals_l = [], [], []
        for k, off in enumerate(offsets):
            nb = multi + np.asarray(off)
            ok = np.ones(N, dtype=bool)
            for ax in range(len(grid)):
                ok &= (nb[:, ax] >= 0) & (nb[:, ax] < grid[ax])
            cols = np.ravel_multi_index(tuple(nb[ok].T), grid)
            vals = np.asarray(coeffs[k], dtype=np.float64).reshape(-1)[ok]
            nz = vals != 0
            rows_l.append(idx[ok][nz])
            cols_l.append(cols[nz])
            vals_l.append(vals[nz])
        A_sp = sp.csr_matrix((np.concatenate(vals_l),
                              (np.concatenate(rows_l), np.concatenate(cols_l))), shape=(N, N))
        return MatAIJ.from_scipy(A_sp, comm=comm, grid=grid)

    # ---------------- sizes ----------------

    def setSizes(self, size, bs: int = 1):
        m, n = size if isinstance(size, tuple) else (size, size)
        P = self.comm.nshards
        self.row_layout = Layout(int(m), P, bs=bs, axis=self.comm.axis)
        self.col_layout = Layout(int(n), P, bs=bs, axis=self.comm.axis)
        return self

    def setBlockSize(self, bs: int):
        """MatSetBlockSize (mat.py:126-134): the dof blocking of rows and
        columns; an assembled matrix re-lays its device copy for it (a
        MatAIJ with bs > 1 takes the block layout)."""
        P = self.comm.nshards
        self.row_layout = Layout(self.row_layout.N, P, bs=int(bs), axis=self.comm.axis)
        self.col_layout = Layout(self.col_layout.N, P, bs=int(bs), axis=self.comm.axis)
        self._relayout()
        return self

    def _relayout(self):
        """Rebuild the device copy after a change of block size (nothing
        for a Mat without an assembled host copy)."""

    def getBlockSize(self):
        return self.row_layout.bs

    def isAssembled(self):
        return self._assembled

    def getSize(self):
        return (self.row_layout.N, self.col_layout.N)

    def getLocalSize(self):
        return (self.row_layout.block, self.col_layout.block)

    def getOwnershipRange(self):
        return self.row_layout.range(self.comm.rank)

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

    def multAdd(self, x: Vec, v: Vec, y: Vec):
        """y <- A x + v."""
        y.array = self.op().mult(x.array) + v.array
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

    def setNullSpace(self, ns):
        self.nullspace = ns

    def setNearNullSpace(self, ns):
        """The near-nullspace GAMG's tentative prolongator takes: an (N,) or
        (N, k) array, an object with `.vectors`, or a MatNullSpace (the
        rigid-body modes of ``MatNullSpace.createRigidBody`` among them)."""
        self.near_nullspace = ns

    def getNearNullSpace(self):
        return self.near_nullspace

    def setOption(self, name, flag=True):
        if name in ("symmetric", "spd"):
            self.symmetric = bool(flag)

    def view(self, viewer=None):
        m, n = self.getSize()
        print(f"Mat Object: type: {type(self).__name__.lower()}")
        print(f"  rows={m}, cols={n}")


class MatShell(Mat):
    """A matrix-free operator (MATSHELL, src/mat/impls/shell; mat.py:
    252-282): callables on tensors registered with
    ``operator.register_shell``; ``meta`` carries the handle and the
    context travels as the device data, so the binder calls ``mult(ctx,
    x)`` only when a context was given."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._handle = None
        self._context = None

    def setShellOperations(self, mult, mult_transpose=None, diag=None, context=None):
        self._handle = operator.register_shell(
            {"mult": mult, "mult_t": mult_transpose, "diag": diag})
        self._context = context
        self._assembled = True
        return self

    @property
    def meta(self):
        return ("shell", self._handle)

    def device_data(self):
        return self._context


class MatDense(Mat):
    """A dense matrix (MATDENSE, src/mat/impls/dense; mat.py:285-325), on
    the device of ``config.init`` in the real dtype; its products are
    ``torch.mv`` (the reference leaves ``a @ x`` to XLA)."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._a = None

    def setDenseArray(self, a):
        a = np.asarray(a)
        m, n = self.getSize()
        ap = np.zeros((m, n), dtype=np.float64)
        ap[: a.shape[0], : a.shape[1]] = a
        self._a = torch.as_tensor(ap, dtype=config.real_dtype(), device=config.device())
        self._assembled = True
        self.increase_state()
        return self

    def getDenseArray(self):
        return self._a.cpu().numpy()

    @property
    def meta(self):
        return ("dense", self.row_layout.Npad, self.col_layout.Npad)

    def device_data(self):
        return {"a": self._a}

    def norm(self, norm_type=NormType.NORM_FROBENIUS):
        a = self.getDenseArray().astype(np.float64)
        if norm_type == NormType.NORM_FROBENIUS:
            return float(np.linalg.norm(a))
        if norm_type == NormType.NORM_1:
            return float(np.abs(a).sum(axis=0).max())
        if norm_type == NormType.NORM_INFINITY:
            return float(np.abs(a).sum(axis=1).max())
        raise ValueError(norm_type)


def _bind_dense(meta, data):
    a = data["a"]
    return operator.Op(mult=lambda x: torch.mv(a, x), mult_t=lambda x: torch.mv(a.T, x),
                       diag=lambda: torch.diagonal(a))


operator.register_binder("dense", _bind_dense)


class MatNullSpace:
    """A (near-)nullspace (reference src/mat/interface/matnull.c; mat.py:
    336-383): the vectors GAMG's tentative prolongator takes."""

    def __init__(self, constant=True, vectors=()):
        self.has_constant = bool(constant)
        self.vectors = list(vectors)
        self._dense = None

    def as_dense(self, n):
        """The vectors as an (n, k) numpy block, the constant column first."""
        cols = [np.full((n,), 1.0)] if self.has_constant else []
        cols += [np.asarray(v.getArray() if isinstance(v, Vec) else v, dtype=np.float64)
                 for v in self.vectors]
        return np.stack(cols, axis=1) if cols else np.ones((n, 1))

    @staticmethod
    def createRigidBody(coords):
        """The rigid-body modes of elasticity (MatNullSpaceCreateRigidBody)
        over (npoints, dim) coordinates, interlaced by point: 3 modes in
        2-D (two translations, the rotation), 6 in 3-D (three
        translations, then the rotations about x, y and z)."""
        coords = np.asarray(coords, dtype=np.float64)
        npts, dim = coords.shape
        if dim == 2:
            modes = np.zeros((npts * 2, 3))
            modes[0::2, 0] = 1.0
            modes[1::2, 1] = 1.0
            modes[0::2, 2] = -coords[:, 1]
            modes[1::2, 2] = coords[:, 0]
        elif dim == 3:
            modes = np.zeros((npts * 3, 6))
            for d in range(3):
                modes[d::3, d] = 1.0
            x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
            modes[1::3, 3], modes[2::3, 3] = -z, y      # about x
            modes[0::3, 4], modes[2::3, 4] = z, -x      # about y
            modes[0::3, 5], modes[1::3, 5] = -y, x      # about z
        else:
            raise ValueError(f"createRigidBody: {dim}-D coordinates (2 or 3)")
        ns = MatNullSpace(constant=False)
        ns._dense = modes
        return ns

    def dense_or(self, n):
        """The rigid-body modes where this space holds them, else as_dense(n)."""
        return self._dense if self._dense is not None else self.as_dense(n)


__all__ = ["Mat", "MatShell", "MatDense", "MatNullSpace", "MatStructure"]
