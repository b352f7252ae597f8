"""petsc_tpu_torch — the PyTorch/CUDA port of petsc_tpu.

A second package beside ``petsc_tpu`` with the same public surface for
what it ports so far: the options database, Vec, the stencil Mat of the
3-D Poisson operator, the assembled MatAIJ (setValues, CSR and COO
assembly, the host matrix operations and sparse products), MatSBAIJ,
MatShell, MatDense, the wrapper Mats (MatTranspose, MatNormal,
MatDiagonal, MatComposite, MatLRC, MatNest, MatSchurComplement, MatMAIJ,
MatIS, and MatKAIJ and MatFFT in ``mat.extra_formats``), orderings,
colourings, MatFDColoring and MatPartitioning, PC
none/jacobi/pbjacobi/shell/mg/gamg/ilu/icc/lu/cholesky/bjacobi/sor, KSP
cg/richardson/preonly/chebyshev/gmres/fgmres/bcgs/minres with matSolve,
the profiler's stages, events and nested views, the converged-reason
enums, DM/DMDA with KSP.setDM and PCMG from a DM (PETSc's ex45), the
nonlinear layer: SNES (with its line searches, JFNK and FD-colouring
Jacobians), TS (with events, trajectories and adjoints) and Tao, and
DMPlex with its transforms and Exodus I/O, PetscFE/PetscDS weak-form
assembly (``dm/fe.py``, ``dm/multids.py``) and finite volumes
(``dm/fv.py``, ``dm/fv_plex.py``; PETSc's SNES ex12), the rest of DM
(DMStag with its MAC Stokes example, DMComposite, DMShell, DMRedundant,
DMSwarm with its particle kernels, DMNetwork, Plex HDF5), index sets and
AO, the viewers (PETSc binary, HDF5, VTK), PetscDraw, PetscBag, PF,
PetscRandom, -info, the ML layer (LETKF, PetscRegressor) and the petsc4py
namespace (``petsc4py_compat.PETSc``). It
imports torch, numpy and scipy, never jax or petsc_tpu. Objects live on
the device :func:`init` chooses: ``cuda`` unless ``device="cpu"`` is
passed. The CG body runs on hand-written Hopper kernels
(``petsc_tpu_torch/csrc``, built at first use).

Quick start::

    import petsc_tpu_torch as pt
    from petsc_tpu_torch.ops import stencil_build
    pt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8"])
    meta, data = stencil_build.build_dnd((128, 128, 128), kind="box")
    A = stencil_build.as_mat(meta, data)
    ksp = pt.KSP().create(); ksp.setOperators(A); ksp.setFromOptions()
    b = A.createVecLeft(); b.set(1.0)
    x = ksp.solve(b)

or, for an assembled matrix, ``A = pt.MatAIJ(); A.setSizes(N);
A.setPreallocationCOO(i, j); A.setValuesCOO(v)`` (or ``setValues`` and
``assemble()``) in place of the stencil Mat; with no ``-ksp_type`` and no
``-pc_type`` it solves with PETSc's defaults, GMRES(30) and ILU(0). On a
grid, a DMDA builds the operator through callbacks (PETSc's ex45)::

    pt.init(args=["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8"])
    da = pt.DMDA.create(3, (129, 129, 129))
    ksp = pt.KSP().create(); ksp.setDM(da)
    ksp.setComputeOperators(fn_A); ksp.setComputeRHS(fn_b); ksp.setFromOptions()
    x = ksp.solve()

(``petsc_tpu_torch/examples/ex45.py``).
"""

from . import config
from .config import init, finalize, options, log, real_dtype, set_real_dtype
from .sys.error import (Error, KSPConvergedReason, SNESConvergedReason,
                        TSConvergedReason, TaoConvergedReason, PCFailedReason,
                        NotConvergedError)
from .parallel.layout import Layout
from .parallel.mesh import Comm, comm_self, comm_world, make_comm, make_comm2
from .vec.vec import Vec, NormType, InsertMode, fused_reductions
from .mat.mat import Mat, MatShell, MatDense, MatNullSpace, MatStructure
from .mat.aij import MatAIJ  # also registers the aij_csr and aij_dnd binders
from .mat.sbaij import MatSBAIJ
from .mat.utility import (MatComposite, MatDiagonal, MatIS, MatLRC, MatMAIJ, MatNormal,
                          MatSchurComplement, MatTranspose)
from .mat import extra_formats as _extra_formats  # registers mat_fft and mat_kaij
from .pc.pc import PC
from .pc import mg as _mg  # registers PC mg and the pc_mg binder
from .pc import gamg as _gamg  # registers PC gamg and hmg
from .pc import factor_pc as _factor_pc  # registers PC ilu, icc, lu, cholesky, bjacobi
from .pc import more_pc as _more_pc  # registers PC sor, asm, composite, ksp, fieldsplit
from .pc import extras_pc as _extras_pc  # registers the other PCs of extras_pc.py
from .pc import r3_pc as _r3_pc  # registers PC qr, spai, nn
from .pc import bddc as _bddc  # registers PC bddc
from .ksp.ksp import KSP
from .dm.dm import DM
from .dm.da import DMDA
from .snes import SNES  # also registers the SNES types of snes/impls_more.py
from .ts import TS, TSAdapt  # also registers the TS types of ts/impls_more.py
from .tao import Tao  # also registers the Tao types of tao/impls_more.py
from .dm.swarm import DMSwarm
from .dm.network import DMNetwork

__version__ = "0.1.0"


def __getattr__(name):
    # the reference's lazy exports (petsc_tpu/__init__.py:48-53)
    if name == "MatColoring":
        from .mat.coloring import MatColoring
        return MatColoring
    if name == "MatFDColoring":
        from .mat.fdcoloring import MatFDColoring
        return MatFDColoring
    if name == "DMPlex":
        from .dm.plex import DMPlex
        return DMPlex
    # and :34-35, :43-100
    if name == "IS":
        from .parallel.index import IS
        return IS
    if name == "DMStag":
        from .dm.stag import DMStag
        return DMStag
    if name == "DMComposite":
        from .dm.composite import DMComposite
        return DMComposite
    if name == "Regressor":
        from .ml.regressor import Regressor
        return Regressor
    if name == "AO":
        from .parallel.ao import AO
        return AO
    if name == "Random":
        from .sys.random import Random
        return Random
    if name == "viewer":
        from .sys import viewer
        return viewer
    if name == "VecGhost":
        from .vec.ghost import VecGhost
        return VecGhost
    if name == "VecNest":
        from .vec.nest import VecNest
        return VecNest
    raise AttributeError(name)
