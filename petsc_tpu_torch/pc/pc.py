"""PC: preconditioners.

Counterpart of ``petsc_tpu/pc/pc.py`` (reference PC interface,
src/ksp/pc/interface/precon.c — PCApply :523, PCSetUp :1095 with its
operator-state reuse logic), with the types ``none``, ``jacobi`` (the
``diagonal``, ``rowmax``, ``rowsum`` and ``rowl1`` variants, jacobi.c;
zero entries are fixed to 1.0), ``pbjacobi`` and ``shell`` here; ``mg``,
``gamg``, the factorizations (``pc/factor_pc.py``) and ``sor``
(``pc/more_pc.py``) register themselves. setup() builds (meta, data);
``ops.operator`` binders reconstruct apply(x).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config
from ..ops import operator
from ..sys.error import Error, PCFailedReason
from ..sys.object import PObject


class PCSide:
    LEFT = "left"
    RIGHT = "right"
    SYMMETRIC = "symmetric"


class PC(PObject):
    _class_name = "PC"
    _impls: dict[str, type] = {}

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self.mat = None           # operator A
        self.pmat = None          # matrix the PC is built from
        self._impl = None
        self._meta = None
        self._data = None
        self.failed_reason = PCFailedReason.NOERROR
        self._type = None
        self.side = PCSide.LEFT

    @classmethod
    def register_impl(cls, name, impl):
        cls._impls[name] = impl

    def create(self, comm=None):
        self.comm = comm or self.comm
        return self

    def setOperators(self, A, P=None):
        self.mat = A
        self.pmat = P if P is not None else A
        if self.comm is None:
            self.comm = A.comm
        self._setup_called = False
        return self

    def getOperators(self):
        return self.mat, self.pmat

    def setType(self, name: str):
        if name not in self._impls:
            raise Error(f"PC type '{name}' is not ported to petsc_tpu_torch "
                        f"(ported: {', '.join(sorted(self._impls))}); see "
                        "ROADMAP.md queue 1")
        if self._type != name:
            self._type = name
            self._impl = self._impls[name](self)
            self._setup_called = False
        return self

    def getType(self):
        return self._type

    def setCoordinates(self, coords):
        """PCSetCoordinates (gamg.c): nodal coordinates, kept on the host."""
        self._coords = np.asarray(coords, dtype=np.float64)
        return self

    # -------- fieldsplit public surface (petsc4py PC naming, pc.py:100-131) --------

    def _fieldsplit(self):
        if self._impl is None or self._type != "fieldsplit":
            self.setType("fieldsplit")
        return self._impl

    def setFieldSplitIS(self, *fields):
        """PCFieldSplitSetIS (fieldsplit.c): each field a (name, indices) pair."""
        impl = self._fieldsplit()
        for name, iset in fields:
            impl.setIS(name, iset)
        return self

    def setFieldSplitFields(self, bs, *fields):
        """PCFieldSplitSetFields: strided component splits of block size bs
        (each field a component index or tuple of components)."""
        self._fieldsplit().setFields(bs, *fields)
        return self

    def setFieldSplitType(self, ftype):
        """PCFieldSplitSetType: additive | multiplicative |
        symmetric_multiplicative | schur."""
        self._fieldsplit().ftype = ftype
        return self

    def setFieldSplitSchurPreType(self, pre):
        """PCFieldSplitSetSchurPre: a11 | selfp."""
        self._fieldsplit().schur_pre = pre
        return self

    def setShellApply(self, apply, apply_transpose=None, context=None):
        """PCShellSetApply: the type becomes ``shell``; apply(x), or
        apply(context, x) when a context is given, maps a tensor to a tensor."""
        self.setType("shell")
        self._impl.set_apply(apply, apply_transpose, context)
        return self

    def setFromOptions(self):
        t = self.opt("get_string", "pc_type", default=None)
        if t:
            self.setType(t)
        if self._impl is None:
            self.setType(self.default_type())
        if hasattr(self._impl, "set_from_options"):
            self._impl.set_from_options()
        return self

    def default_type(self):
        # PETSc's defaults: ilu for an assembled AIJ matrix on one rank,
        # block Jacobi on several; for a stencil Mat the reference defaults
        # to none
        if self.pmat is not None and getattr(self.pmat.comm, "nshards", 1) > 1:
            return "bjacobi"
        from ..mat.aij import MatAIJ
        return "ilu" if isinstance(self.pmat, MatAIJ) else "none"

    def setUp(self):
        """PCSetUp (precon.c:1095): rebuild only if the operator changed
        since the last setup — the state-counter reuse logic."""
        if self._type is None:
            self.setFromOptions()
        if self._setup_called and self.pmat is not None \
                and self._setup_state == self.pmat.state:
            return self
        t0 = time.perf_counter()
        self._meta, self._data = self._impl.setup()
        config.log().log_event(f"PCSetUp_{self._type}", time.perf_counter() - t0)
        self._setup_called = True
        if self.pmat is not None:
            self._setup_state = self.pmat.state
        return self

    # ---------------- contract ----------------

    @property
    def meta(self):
        self.setUp()
        return self._meta

    def device_data(self):
        self.setUp()
        return self._data

    def op(self) -> operator.Op:
        return operator.bind(self.meta, self.device_data())

    def apply(self, x, y=None):
        """y <- B x (precon.c:523)."""
        if y is None:
            y = x.duplicate()
        y.array = self.op().mult(x.array)
        return y

    def applyTranspose(self, x, y=None):
        """y <- B^T x (PCApplyTranspose)."""
        if y is None:
            y = x.duplicate()
        op = self.op()
        if op.mult_t is None:
            raise Error(f"PC {self._type} has no transpose apply")
        y.array = op.mult_t(x.array)
        return y

    def view(self, viewer=None):
        print(f"PC Object: ({self._prefix}) type: {self._type}")


# =====================================================================
# basic impls
# =====================================================================

class _PCNone:
    def __init__(self, pc):
        self.pc = pc

    def setup(self):
        return ("pc_none",), {}


def _bind_pc_none(meta, data):
    return operator.Op(mult=lambda x: x, mult_t=lambda x: x)


class _PCJacobi:
    """Diagonal scaling (jacobi.c). Variants: diagonal (default), rowmax,
    rowsum, rowl1 (the last three from the host CSR); -pc_jacobi_abs takes
    absolute values; zero entries are fixed to 1.0. A scalar diagonal (a
    constant stencil, ops/stencil_build.py) stays a scalar."""

    def __init__(self, pc):
        self.pc = pc
        self.variant = "diagonal"
        self.use_abs = False
        self.rowl1_scale = 1.0

    def set_from_options(self):
        o = self.pc
        t = o.opt("get_string", "pc_jacobi_type", default=None)
        if t:
            self.variant = t
        if o.opt("get_bool", "pc_jacobi_abs", default=False):
            self.use_abs = True

    def setup(self):
        A = self.pc.pmat
        if self.variant == "diagonal":
            d = A.op().diag()
        else:
            sp = A.to_scipy()
            if self.variant == "rowmax":
                d = abs(sp).max(axis=1).toarray().ravel()
            elif self.variant == "rowsum":
                d = np.asarray(sp.sum(axis=1)).ravel()
            elif self.variant == "rowl1":
                absrow = np.asarray(abs(sp).sum(axis=1)).ravel()
                diag = sp.diagonal()
                d = diag + self.rowl1_scale * (absrow - np.abs(diag))
            else:
                raise Error(f"unknown jacobi variant {self.variant}")
            d = torch.as_tensor(d, dtype=config.real_dtype()).to(config.device())
        if self.use_abs:
            d = torch.abs(d)
        inv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)
        return ("pc_jacobi",), {"inv": inv}


def _bind_pc_jacobi(meta, data):
    inv = data["inv"]
    return operator.Op(mult=lambda x: inv * x, mult_t=lambda x: inv * x,
                       diag=lambda: inv)


class _PCPBJacobi:
    """Point-block Jacobi: the bs x bs diagonal blocks of the host CSR
    (bs from the matrix, else -pc_pbjacobi_block_size), inverted in one
    batch on the host (a singular block gets the identity added), applied
    on the device by a batched product."""

    def __init__(self, pc):
        self.pc = pc

    def setup(self):
        A = self.pc.pmat
        bs = A.getBlockSize()
        if bs <= 1:
            bs = self.pc.opt("get_int", "pc_pbjacobi_block_size", default=1)
        m = A.row_layout.N
        if m % bs:
            raise Error(f"rows {m} not divisible by block size {bs}")
        coo = A.to_scipy().tocoo()
        sel = (coo.row // bs) == (coo.col // bs)
        r, c, v = coo.row[sel], coo.col[sel], coo.data[sel]
        blocks = np.zeros((m // bs, bs, bs))
        blocks[r // bs, r % bs, c % bs] = v
        singular = np.abs(np.linalg.det(blocks)) < 1e-300
        blocks[singular] += np.eye(bs)[None]
        inv = torch.as_tensor(np.linalg.inv(blocks), dtype=config.real_dtype())
        return ("pc_pbjacobi", bs), {"inv": inv.to(config.device())}


def _bind_pc_pbjacobi(meta, data):
    bs = meta[1]
    inv = data["inv"]

    def mult(x):
        return torch.bmm(inv, x.reshape(-1, bs, 1)).reshape(-1)

    def mult_t(x):
        return torch.bmm(inv.transpose(1, 2), x.reshape(-1, bs, 1)).reshape(-1)

    return operator.Op(mult=mult, mult_t=mult_t)


class _PCShell:
    def __init__(self, pc):
        self.pc = pc
        self.handle = None
        self.context = None

    def set_apply(self, apply, apply_transpose=None, context=None):
        self.handle = operator.register_shell(
            {"mult": apply, "mult_t": apply_transpose, "diag": None})
        self.context = context
        return self

    def setup(self):
        if self.handle is None:
            raise Error("PCShell: call pc.setShellApply(fn) first")
        return ("shell", self.handle), self.context


PC.register_impl("none", _PCNone)
PC.register_impl("jacobi", _PCJacobi)
PC.register_impl("pbjacobi", _PCPBJacobi)
PC.register_impl("shell", _PCShell)

operator.register_binder("pc_none", _bind_pc_none)
operator.register_binder("pc_jacobi", _bind_pc_jacobi)
operator.register_binder("pc_pbjacobi", _bind_pc_pbjacobi)
