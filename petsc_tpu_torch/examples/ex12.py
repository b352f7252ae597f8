"""ex12 analog: nonlinear FEM Poisson on DMPlex with PetscDS weak forms.

The port's copy of ``examples/ex12.py``, the analog of PETSc's
src/snes/tutorials/ex12.c: -div((1+u^2) grad u) = f on the unit square,
Dirichlet BC, Lagrange elements of selectable order (-fe_order, default
2), SNES Newton with the element Jacobian derived from the registered
f0/f1 by forward-mode autodiff (the g0..g3 blocks of ex12.c).

The manufactured forcing is itself autodiff-derived: pick u_ex, define
the flux F(x) = (1+u^2) grad u at u = u_ex, and f = -div F comes from
``torch.func.jacfwd`` of ``torch.func.grad`` — no hand-computed
right-hand side.

On the device the residual is the DS's K8 gather, batched element kernel
and X1 scatter-add, with the Dirichlet rows set by one index write; the
Jacobian's COO pattern (Dirichlet rows identity, their columns removed
from the other rows, as the reference's scipy callback leaves them) is
fixed at the first Newton step, and each step's values are one K8 gather
of the element Jacobians and ``setValuesCOO`` (DS.assembleJacobianCOO).
The nodal error evaluates u_exact on every dof coordinate in one torch
expression (the reference calls JAX once per dof).

    python -m petsc_tpu_torch.examples.ex12 -fe_order 2 -faces 12
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

import petsc_tpu_torch as pt
from petsc_tpu_torch.dm.fe import DS, lagrange_fe
from petsc_tpu_torch.dm.plex import DMPlex


def u_exact(x):
    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])


def forcing(x):
    """f = -div((1+u^2) grad u) at u = u_exact, by nested autodiff."""
    def flux(y):
        g = torch.func.grad(u_exact)(y)
        u = u_exact(y)
        return (1.0 + u * u) * g

    return -torch.diagonal(torch.func.jacfwd(flux)(x)).sum()


class Ex12:
    """ex12's objects on the device init() chose, built once: the box mesh,
    the DS and its Dirichlet dofs, the SNES with its residual and Jacobian
    callbacks. solve() runs Newton from zero; seconds holds the host
    seconds by part (mesh, dof_layout, and residual, jacobian and coo
    summed over the callbacks)."""

    def __init__(self, order=2, faces=12):
        self.order, self.faces = order, faces
        secs = {"residual": 0.0, "jacobian": 0.0, "coo": 0.0}
        self.seconds = secs
        t = time.perf_counter()
        plex = DMPlex.createBoxMesh((faces, faces), simplex=True)
        secs["mesh"] = time.perf_counter() - t
        t = time.perf_counter()
        ds = DS(plex, lagrange_fe(2, order))
        secs["dof_layout"] = time.perf_counter() - t
        ds.setResidual(f0=lambda u, gu, x: -forcing(x),
                       f1=lambda u, gu, x: (1.0 + u * u) * gu)
        xy = ds.dof_coords
        # ds.boundary_dofs(lambda x: x.min() < 1e-9 or x.max() > 1 - 1e-9), vectorised
        bnd = np.flatnonzero((xy.min(axis=1) < 1e-9) | (xy.max(axis=1) > 1 - 1e-9))
        n = ds.ndof
        dev = pt.config.device()
        bidx = torch.as_tensor(bnd, device=dev)

        def residual(snes, x, f):
            t0 = time.perf_counter()
            u = x.array
            F = ds.assembleResidual(u)
            F[bidx] = u[bidx]                        # essential BC: u = 0
            f.array = F
            secs["residual"] += time.perf_counter() - t0

        def jacobian(snes, x, J, P):
            t0 = time.perf_counter()
            Ke = ds.elementJacobians(x.array)
            t1 = time.perf_counter()
            ds.assembleJacobianCOO(x.array, P, bnd, Ke=Ke)
            secs["jacobian"] += t1 - t0
            secs["coo"] += time.perf_counter() - t1

        snes = pt.SNES().create()
        J = pt.MatAIJ(None)
        J.setSizes((n, n))
        self.f = pt.Vec.from_array(np.zeros(n))
        snes.setFunction(residual, self.f)
        snes.setJacobian(jacobian, J, J)
        snes.setTolerances(rtol=1e-10, atol=1e-12)
        snes.setFromOptions()
        self.plex, self.ds, self.bnd, self.snes, self.J, self.n = plex, ds, bnd, snes, J, n

    def solve(self):
        """Newton from u = 0; returns the solution Vec."""
        x = pt.Vec.from_array(np.zeros(self.n))
        self.snes.solve(None, x)
        return x

    def nodal_error(self, x):
        """max |u - u_exact| over the dof coordinates, one torch expression."""
        xt = torch.as_tensor(self.ds.dof_coords, dtype=x.array.dtype, device=x.array.device)
        uex = torch.sin(torch.pi * xt[:, 0]) * torch.sin(torch.pi * xt[:, 1])
        return float(torch.abs(x.array - uex).max())


def main(argv=None, device=None):
    """Solve; return (max nodal error, snes). The card unless
    device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    opts = pt.options()
    order = opts.get_int("fe_order", default=2)
    faces = opts.get_int("faces", default=12)
    prob = Ex12(order, faces)
    x = prob.solve()
    err = prob.nodal_error(x)
    snes = prob.snes
    print(f"P{order} nonlinear Poisson: {faces}x{faces} mesh, "
          f"{snes.getIterationNumber()} Newton its, max error {err:.3e}")
    return err, snes


if __name__ == "__main__":
    main()
