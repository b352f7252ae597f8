"""The 3-D Laplacian with multigrid on a DMDA.

The port's copy of ``examples/ex45.py``, the analog of PETSc's
src/ksp/ksp/tutorials/ex45.c: the 7-point finite-difference Laplacian on
the unit cube with Dirichlet boundaries (boundary rows the scaled
diagonal alone), the right-hand side 2 hx hy hz inside and 0 on the
boundary, solved with whatever -ksp_type and -pc_type the options give
(ex45's test: CG with PCMG from the DM, each coarse level rediscretized
by ``compute_operators``).

    python -m petsc_tpu_torch.examples.ex45 -da_grid_x 33 -da_grid_y 33 \\
        -da_grid_z 33 -ksp_type cg -pc_type mg -ksp_monitor_short

``component_laplacian`` writes the operator's COO triplets for each of a
DMDA's dof components (the components decoupled); at dof 1 they are the
reference's ``compute_operators`` triplets in its order.
"""

from __future__ import annotations

import sys

import numpy as np

import petsc_tpu_torch as pt


def compute_rhs(ksp, b):
    da = b._dm
    nx, ny, nz = da.sizes
    hx, hy, hz = 1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1)
    arr = np.full((nz, ny, nx), 2.0 * hx * hy * hz)
    # boundary nodes: the Dirichlet value 0
    arr[0, :, :] = arr[-1, :, :] = 0.0
    arr[:, 0, :] = arr[:, -1, :] = 0.0
    arr[:, :, 0] = arr[:, :, -1] = 0.0
    da.setVecArray(b, arr)


def component_laplacian(da):
    """COO (i, j, v) of ex45's operator for each of da.dof components:
    component c of node (x, y, z) is row dof_index(x, y, z, c); a boundary
    row holds its diagonal alone, an interior row the 7-point stencil with
    ex45's scaled coefficients; no coupling between components."""
    nx, ny, nz = da.sizes
    hx, hy, hz = 1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1)
    hhx, hhy, hhz = hy * hz / hx, hx * hz / hy, hx * hy / hz
    xyz = da.node_coords()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    interior = da.interior_mask()
    xi, yi, zi = x[interior], y[interior], z[interior]
    diag = 2.0 * (hhx + hhy + hhz)
    ii, jj, vv = [], [], []
    for c in range(da.dof):
        idx = da.dof_index(x, y, z, c=c)
        B, I = idx[~interior], idx[interior]
        ii += [B, I]
        jj += [B, I]
        vv += [np.full(len(B), diag), np.full(len(I), diag)]
        for d, h in ((da.dof_index(xi - 1, yi, zi, c=c), hhx),
                     (da.dof_index(xi + 1, yi, zi, c=c), hhx),
                     (da.dof_index(xi, yi - 1, zi, c=c), hhy),
                     (da.dof_index(xi, yi + 1, zi, c=c), hhy),
                     (da.dof_index(xi, yi, zi - 1, c=c), hhz),
                     (da.dof_index(xi, yi, zi + 1, c=c), hhz)):
            ii.append(I)
            jj.append(d)
            vv.append(np.full(len(I), -h))
    return np.concatenate(ii), np.concatenate(jj), np.concatenate(vv)


def compute_operators(ksp, A, B):
    i, j, v = component_laplacian(A._dm)
    A.setPreallocationCOO(i, j)
    A.setValuesCOO(v)


def main(argv=None, device=None):
    """Solve on a 7^3 DMDA (or -da_grid_x|y|z), print the residual norm and
    the iterations, return the KSP. The card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    da = pt.DMDA.create(3, (7, 7, 7), dof=1, stencil_width=1)
    da.setFromOptions()

    ksp = pt.KSP().create()
    ksp.setDM(da)
    ksp.setComputeRHS(compute_rhs)
    ksp.setComputeOperators(compute_operators)
    ksp.setFromOptions()

    x = ksp.solve()
    r = ksp.mat.createVecLeft()
    ksp.mat.mult(x, r)
    b = da.createGlobalVector()
    compute_rhs(ksp, b)
    r.axpy(-1.0, b)
    print(f"Residual norm {float(r.norm()):g}")
    print(f"iterations {ksp.getIterationNumber()}")
    return ksp


if __name__ == "__main__":
    main()
