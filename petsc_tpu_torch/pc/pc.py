"""PC: preconditioners.

Counterpart of ``petsc_tpu/pc/pc.py`` (reference PC interface,
src/ksp/pc/interface/precon.c — PCApply :523, PCSetUp :1095 with its
operator-state reuse logic), with the types ``none`` and ``jacobi`` (its
``diagonal`` variant, jacobi.c; zero diagonal entries are fixed to 1.0)
here; ``mg``, ``gamg``, the factorizations (``pc/factor_pc.py``) and
``sor`` (``pc/more_pc.py``) register themselves. setup() builds (meta,
data); ``ops.operator`` binders reconstruct apply(x).
"""

from __future__ import annotations

import time

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
        # PETSc's default for an assembled AIJ matrix on one device is ilu;
        # for a stencil Mat the reference defaults to none
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
    """Diagonal scaling (jacobi.c), ``diagonal`` variant; zero entries of
    the diagonal are fixed to 1.0. A scalar diagonal (a constant stencil,
    ops/stencil_build.py) stays a scalar."""

    def __init__(self, pc):
        self.pc = pc
        self.variant = "diagonal"
        self.use_abs = False

    def set_from_options(self):
        o = self.pc
        t = o.opt("get_string", "pc_jacobi_type", default=None)
        if t:
            self.variant = t
        if o.opt("get_bool", "pc_jacobi_abs", default=False):
            self.use_abs = True

    def setup(self):
        if self.variant != "diagonal":
            raise Error(f"PC jacobi variant '{self.variant}' is not ported "
                        "(only 'diagonal')")
        d = self.pc.pmat.op().diag()
        if self.use_abs:
            d = torch.abs(d)
        inv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)
        return ("pc_jacobi",), {"inv": inv}


def _bind_pc_jacobi(meta, data):
    inv = data["inv"]
    return operator.Op(mult=lambda x: inv * x, mult_t=lambda x: inv * x,
                       diag=lambda: inv)


PC.register_impl("none", _PCNone)
PC.register_impl("jacobi", _PCJacobi)

operator.register_binder("pc_none", _bind_pc_none)
operator.register_binder("pc_jacobi", _bind_pc_jacobi)
