"""The Q1 grid transfer of the structured GAMG head and DMDA multigrid.

Counterpart of ``petsc_tpu/dm/interp.py`` (reference
src/dm/impls/da/dainterp.c:39-605, the DMDA Q1 interpolation that PCMG
uses): vertex-centred factor-2 Q1 prolongation, nc = (nf + 1) // 2 -> nf
per axis, even fine sizes clamping their last odd point; restriction is
its exact adjoint. The operator presents as a Mat (meta, data) so PCMG
composes it like any other interpolation; it is never assembled on the
card. Its product is the fused hand kernel Q1P and its transpose Q1R
(:mod:`..ops.grid_kernels`), whose plain versions are the reference's
per-axis ``_interp_axis`` and ``_restrict_axis``. ``to_scipy`` assembles
it on the host for the Galerkin product of the host structured head and of
PCMG's coarse levels.

A field of ``dof > 1`` components per point (a DMDA's layout, the
components innermost) interpolates each component alike: P is
``kron(P_grid, I_dof)`` (interp.py:72-118), its products the kernels' dof
entries. The slab-sharded ``MatInterpQ1MPI`` comes with distribution
(ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import numpy as np

from ..mat.mat import Mat
from ..ops import operator
from ..ops.grid_kernels import _interp_axis, _restrict_axis, q1_prolong, q1_restrict  # noqa: F401

_ITEM_12 = "distribution (ROADMAP queue 1 item 12)"


class MatInterpQ1(Mat):
    """Q1 prolongation coarse -> fine on (..., ny, nx) grids."""

    def __init__(self, fine_shape, coarse_shape, comm=None, dof=1, **kw):
        if int(dof) < 1:
            raise ValueError(f"MatInterpQ1: dof {dof} < 1")
        fine_shape = tuple(int(s) for s in fine_shape)
        coarse_shape = tuple(int(s) for s in coarse_shape)
        if coarse_shape != tuple((s + 1) // 2 for s in fine_shape):
            raise ValueError(f"MatInterpQ1: coarse grid {coarse_shape} is not (nf + 1) // 2 "
                             f"of {fine_shape}")
        super().__init__(comm, **kw)
        self.fine_shape = fine_shape
        self.coarse_shape = coarse_shape
        self.dof = int(dof)
        self.setSizes((int(np.prod(fine_shape)) * self.dof, int(np.prod(coarse_shape)) * self.dof))
        self._assembled = True

    @property
    def meta(self):
        return ("interp_q1", self.fine_shape, self.coarse_shape, self.dof)

    def device_data(self):
        return {}

    def transpose(self):
        # PCMG only needs mult_t, which the binder gives
        return self

    def to_scipy(self):
        """P assembled on the host (for the host Galerkin product): the
        Kronecker product of the 1-D operators, and of I_dof for dof > 1."""
        import scipy.sparse as sp
        P = None
        for nf, nc in zip(self.fine_shape, self.coarse_shape):
            rows, cols, vals = [], [], []
            for fi in range(nf):
                if fi % 2 == 0:
                    rows.append(fi)
                    cols.append(fi // 2)
                    vals.append(1.0)
                else:
                    hi = min(fi // 2 + 1, nc - 1)   # the clamp of an even nf's last odd point
                    rows += [fi, fi]
                    cols += [fi // 2, hi]
                    vals += [0.5, 0.5]
            p1 = sp.csr_matrix((vals, (rows, cols)), shape=(nf, nc))
            p1.sum_duplicates()
            P = p1 if P is None else sp.kron(P, p1, format="csr")
        if self.dof > 1:
            P = sp.kron(P, sp.eye(self.dof), format="csr")
        return P


class MatInterpQ1MPI(MatInterpQ1):
    """The slab-sharded Q1 prolongation (interp.py:120-146)."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(f"MatInterpQ1MPI comes with {_ITEM_12}")


def _bind_interp_q1_mpi(meta, data):
    raise NotImplementedError(f"the interp_q1_mpi binder comes with {_ITEM_12}")


def _bind_interp_q1(meta, data):
    """mult: Q1P, coarse -> fine; mult_t: Q1R, fine -> coarse, per
    component for dof > 1 (interp.py:219-237)."""
    _, fshape, cshape, dof = (tuple(meta) + (1,))[:4]
    return operator.Op(mult=lambda x: q1_prolong(x, fshape, dof),
                       mult_t=lambda x: q1_restrict(x, fshape, dof))


operator.register_binder("interp_q1", _bind_interp_q1)
operator.register_binder("interp_q1_mpi", _bind_interp_q1_mpi)
