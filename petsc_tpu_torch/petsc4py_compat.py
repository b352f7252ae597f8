"""petsc4py-compatible namespace.

Counterpart of ``petsc_tpu/petsc4py_compat.py`` (reference
src/binding/petsc4py: ``from petsc4py import PETSc``). Existing petsc4py
scripts keep their shape:

    from petsc_tpu_torch.petsc4py_compat import PETSc
    A = PETSc.Mat().createAIJ((n, n), csr=(indptr, indices, vals))
    ksp = PETSc.KSP().create()
    ...

Only naming and ergonomics live here; everything dispatches to the port's
classes.
"""

from __future__ import annotations

import numpy as np

from . import config
from .mat.aij import MatAIJ
from .mat.mat import MatDense, MatShell
from .sys import viewer as _viewer
from .sys.error import (KSPConvergedReason, SNESConvergedReason,
                        TSConvergedReason)
from .vec.vec import InsertMode, NormType, Vec as _Vec


class _MatFactory:
    """PETSc.Mat() factory object."""

    def __call__(self):
        return self

    def createAIJ(self, size, bsize=None, nnz=None, csr=None, comm=None):
        m, n = size if isinstance(size, tuple) else (size, size)
        A = MatAIJ(comm)
        A.setSizes((m, n), bs=bsize or 1)
        if csr is not None:
            A.setValuesCSR(*csr)
            A.assemble()
        return A

    create = createAIJ

    def createDense(self, size, array=None, comm=None):
        m, n = size if isinstance(size, tuple) else (size, size)
        D = MatDense(comm)
        D.setSizes((m, n))
        if array is not None:
            D.setDenseArray(np.asarray(array))
        return D

    def createPython(self, size, context=None, comm=None):
        m, n = size if isinstance(size, tuple) else (size, size)
        S = MatShell(comm)
        S.setSizes((m, n))
        if context is not None and hasattr(context, "mult"):
            S.setShellOperations(
                mult=lambda x: context.mult(None, x),
                mult_transpose=getattr(context, "multTranspose", None))
        return S


class _VecFactory:
    def __call__(self):
        return self

    def createSeq(self, n, comm=None):
        v = _Vec(comm)
        v.setSizes(int(n))
        v.setUp()
        return v

    createMPI = createSeq
    create = createSeq

    def createWithArray(self, arr, comm=None):
        return _Vec.from_array(np.asarray(arr), comm=comm)


class _Lazy:
    def __init__(self, path):
        self._path = path

    def __call__(self):
        mod, cls = self._path
        import importlib
        m = importlib.import_module(mod, package=__package__)
        return getattr(m, cls)()


class _PETScNS:
    """The PETSc namespace object."""

    Mat = _MatFactory()
    Vec = _VecFactory()
    InsertMode = InsertMode
    NormType = NormType

    class KSP:
        Type = type("Type", (), {n.upper(): n for n in (
            "cg", "gmres", "fgmres", "bcgs", "cgs", "tfqmr", "cr", "gcr",
            "lsqr", "minres", "chebyshev", "richardson", "preonly",
            "pipecg", "groppcg", "bcgsl", "idr", "stcg", "nash", "gltr",
            "qcg", "symmlq", "cgne", "fcg", "lgmres", "ibcgs", "fbcgs",
            "lcd", "tcqmr", "tsirm", "dgmres", "agmres", "fetidp",
            "pgmres", "pipegcr")})
        ConvergedReason = KSPConvergedReason

        def __new__(cls):
            from .ksp.ksp import KSP as _KSP
            return _KSP()

    class PC:
        def __new__(cls):
            from .pc.pc import PC as _PC
            return _PC()

    class SNES:
        ConvergedReason = SNESConvergedReason

        def __new__(cls):
            from .snes.snes import SNES as _SNES
            return _SNES()

    class TS:
        ConvergedReason = TSConvergedReason

        def __new__(cls):
            from .ts.ts import TS as _TS
            return _TS()

    class TAO:
        def __new__(cls):
            from .tao.tao import Tao as _Tao
            return _Tao()

    class DMSwarm:
        def __new__(cls):
            from .dm.swarm import DMSwarm as _DMSwarm
            return _DMSwarm()

    class ViewerHDF5:
        def __new__(cls, path, mode="r"):
            from .sys.hdf5 import ViewerHDF5 as _V
            return _V(path, mode)

    class DMDA:
        def __new__(cls):
            from .dm.da import DMDA as _DMDA
            return _DMDA()

        @staticmethod
        def create(*a, **kw):
            from .dm.da import DMDA as _DMDA
            return _DMDA.create(*a, **kw)

    class IS:
        def __new__(cls):
            from .parallel.index import IS as _IS
            return _IS()

    class Viewer:
        @staticmethod
        def createBinary(name, mode="r", comm=None):
            return _BinaryViewer(name, mode)

    class Options:
        def __init__(self, prefix=""):
            self._prefix = prefix

        def getInt(self, name, default=None):
            return config.options().get_int(name, prefix=self._prefix,
                                            default=default)

        def getReal(self, name, default=None):
            return config.options().get_real(name, prefix=self._prefix,
                                             default=default)

        def getString(self, name, default=None):
            return config.options().get_string(name, prefix=self._prefix,
                                               default=default)

        def getBool(self, name, default=None):
            return config.options().get_bool(name, prefix=self._prefix,
                                             default=default)

        def setValue(self, name, value):
            config.options().set_value(name, value)

    class AO:
        """petsc4py: AO().createBasic(app, petsc) — factory form."""

        @staticmethod
        def createBasic(app, petsc=None, comm=None):
            from .parallel.ao import AO as _AO
            return _AO(app, petsc, comm=comm)

        def __new__(cls):
            return cls

    class Random:
        def __new__(cls):
            from .sys.random import Random as _R
            return _R()

    class Bag:
        def __new__(cls, *a, **kw):
            from .sys.bag import Bag as _B
            return _B(*a, **kw)

    class DMStag:
        def __new__(cls):
            from .dm.stag import DMStag as _D
            return _D()

    class DMPlex:
        def __new__(cls):
            from .dm.plex import DMPlex as _D
            return _D()

    class DMNetwork:
        def __new__(cls):
            from .dm.network import DMNetwork as _D
            return _D()

    class DMComposite:
        def __new__(cls):
            from .dm.composite import DMComposite as _D
            return _D()

    class Section:
        def __new__(cls, *a, **kw):
            from .dm.plex import Section as _S
            return _S(*a, **kw)

    class MatColoring:
        def __new__(cls, *a, **kw):
            from .mat.coloring import MatColoring as _M
            return _M(*a, **kw)

    class DMLabel:
        def __new__(cls, *a, **kw):
            from .dm.label import DMLabel as _L
            return _L(*a, **kw)

    class Partitioner:
        def __new__(cls, *a, **kw):
            from .dm.plex import PetscPartitioner as _P
            return _P(*a, **kw)

    class Log:
        """petsc4py PETSc.Log surface over the profiler."""

        @staticmethod
        def Stage(name):
            log = config.log()

            class _St:
                def push(self):
                    log.stage_push(name)

                def pop(self):
                    log.stage_pop()

                def __enter__(self):
                    self.push()
                    return self

                def __exit__(self, *e):
                    self.pop()
            return _St()

        @staticmethod
        def Event(name):
            log = config.log()

            class _Ev:
                def begin(self):
                    import time
                    self._t0 = time.perf_counter()

                def end(self):
                    import time
                    log.log_event(name, time.perf_counter() - self._t0)
            return _Ev()

        @staticmethod
        def view(*a, **kw):
            config.log().view(*a, **kw)

    COMM_WORLD = None
    COMM_SELF = None


class _BinaryViewer:
    def __init__(self, name, mode):
        self.name = name
        self.mode = mode
        self._appended = False

    def view(self, obj):
        from .mat.mat import Mat
        if isinstance(obj, Mat):
            _viewer.mat_save(self.name, obj, append=self._appended)
        else:
            _viewer.vec_save(self.name, obj, append=self._appended)
        self._appended = True

    def load(self):
        return _viewer.load(self.name)


PETSc = _PETScNS()
