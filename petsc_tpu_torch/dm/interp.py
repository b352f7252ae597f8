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
entries.

``MatInterpQ1MPI`` is the slab-sharded transfer (interp.py:120-216): the
leading axis is split over the ranks (nf0 = 2 nc0, both dividing), and
each rank runs Q1P and Q1R on its slab with a halo plane. Prolongation
takes the next rank's first coarse plane (the last rank its own last
plane, the clamp of an even axis), runs Q1P on the nc0 / P + 1 planes and
keeps the first 2 nc0 / P fine planes. Restriction takes the previous
rank's last fine plane (zero on the first rank) and runs Q1R on the slab
behind two leading planes (a zero and that plane) and, but on the last
rank, one zero plane after it, so that the slab's coarse planes are
interior points of the buffer's grid (the last rank's end clamps as the
global grid's does); it keeps the coarse planes 1 .. nc0 / P.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mat.mat import Mat
from ..ops import operator
from ..ops.grid_kernels import _interp_axis, _restrict_axis, q1_prolong, q1_restrict  # noqa: F401


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

    def __init__(self, fine_shape, coarse_shape, comm, **kw):
        super().__init__(fine_shape, coarse_shape, comm=comm, **kw)
        P = comm.nshards
        if (fine_shape[0] % (2 * P) or coarse_shape[0] % P
                or fine_shape[0] != 2 * coarse_shape[0]):
            raise ValueError("MatInterpQ1MPI slab contract: nf0 = 2 nc0, both dividing "
                             "over the ranks")

    @property
    def meta(self):
        return ("interp_q1_mpi", self.fine_shape, self.coarse_shape, self.comm.nshards)

    def device_data(self):
        return {"comm": self.comm}


def _send_plane(comm, plane, to_next):
    """Send `plane` to the next rank (to_next) or the previous one; returns
    a wait() that gives the plane received from the other side, or None at
    the end of the ranks."""
    P, r = comm.nshards, comm.rank
    dst, src = (r + 1, r - 1) if to_next else (r - 1, r + 1)
    scnt, rcnt = [0] * P, [0] * P
    send = plane.reshape(-1)
    if 0 <= dst < P:
        scnt[dst] = send.numel()
    else:
        send = send[:0]
    has_src = 0 <= src < P
    if has_src:
        rcnt[src] = plane.numel()
    h = comm.alltoallv_start(send, scnt, rcnt)

    def wait():
        recv = h.wait()
        return recv if has_src else None

    return wait


def _bind_interp_q1_mpi(meta, data):
    """mult: Q1P on the rank's coarse slab and the next rank's first plane;
    mult_t: Q1R on the fine slab behind the previous rank's last plane."""
    _, fshape, cshape, P = meta
    comm = data["comm"]
    nzc, nzf = cshape[0] // P, fshape[0] // P
    ctail, ftail = tuple(cshape[1:]), tuple(fshape[1:])
    pc = int(np.prod(ctail)) if ctail else 1
    pf = int(np.prod(ftail)) if ftail else 1
    last = comm.rank == P - 1

    def mult(x):
        wait = _send_plane(comm, x[:pc], to_next=False)
        buf = torch.empty((nzc + 1) * pc, dtype=x.dtype, device=x.device)
        buf[: nzc * pc] = x
        nxt = wait()
        buf[nzc * pc:] = x[(nzc - 1) * pc:] if last else nxt
        return q1_prolong(buf, (2 * nzc + 1,) + ftail)[: nzf * pf]

    def mult_t(x):
        wait = _send_plane(comm, x[(nzf - 1) * pf:], to_next=True)
        nb = nzf + 2 + (0 if last else 1)
        buf = torch.zeros(nb * pf, dtype=x.dtype, device=x.device)
        buf[2 * pf:(2 + nzf) * pf] = x
        prev = wait()
        if prev is not None:
            buf[pf:2 * pf] = prev
        return q1_restrict(buf, (nb,) + ftail)[pc:(nzc + 1) * pc]

    return operator.Op(mult=mult, mult_t=mult_t)


def _bind_interp_q1(meta, data):
    """mult: Q1P, coarse -> fine; mult_t: Q1R, fine -> coarse, per
    component for dof > 1 (interp.py:219-237)."""
    _, fshape, cshape, dof = (tuple(meta) + (1,))[:4]
    return operator.Op(mult=lambda x: q1_prolong(x, fshape, dof),
                       mult_t=lambda x: q1_restrict(x, fshape, dof))


operator.register_binder("interp_q1", _bind_interp_q1)
operator.register_binder("interp_q1_mpi", _bind_interp_q1_mpi)
