"""Bratu's problem in 2-D: -Laplacian(u) - lambda exp(u) = 0.

The port's copy of ``examples/ex5.py``, the analog of PETSc's
src/snes/tutorials/ex5.c (solid-fuel ignition): a DMDA grid, Dirichlet
boundaries, finite differences, Newton with line search. The residual is a
pure torch function of the grid array, written out of place (the interior
stencil padded back onto the grid, the boundary rows F = u by a mask), so
``torch.func`` and autograd carry its derivatives; the assembled
Jacobian has ex5.c's FormJacobianLocal entries, set by COO into the
DMDA's matrix (``aij_dnd`` on the card: V1, and GAMG's structured head).

    python -m petsc_tpu_torch.examples.ex5 -da_grid_x 17 -da_grid_y 17 \\
        -par 6.0 -snes_monitor_short
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as tF

import petsc_tpu_torch as pt


def make_residual(da, lam):
    nx, ny = da.sizes
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    sc = hx * hy * lam
    hxdhy, hydhx = hx / hy, hy / hx
    masks = {}

    def residual(u_flat):
        u = u_flat.reshape(ny, nx)
        interior = masks.get(u.device)
        if interior is None:
            interior = masks[u.device] = tF.pad(
                torch.ones((ny - 2, nx - 2), dtype=torch.bool, device=u.device), (1, 1, 1, 1))
        uc = u[1:-1, 1:-1]
        lap = (2.0 * uc - u[1:-1, :-2] - u[1:-1, 2:]) * hydhx \
            + (2.0 * uc - u[:-2, 1:-1] - u[2:, 1:-1]) * hxdhy
        f_int = tF.pad(lap - sc * torch.exp(uc), (1, 1, 1, 1))
        # boundary rows: F = u (Dirichlet 0, ex5.c FormFunctionLocal)
        return torch.where(interior, f_int, u).reshape(-1)

    return residual


def jacobian_pattern(da):
    """ex5.c's COO pattern (boundary diagonal, then the interior diagonal
    and its four neighbours), the reference's order."""
    xy = da.node_coords()
    xi, yi = xy[:, 0], xy[:, 1]
    interior = da.interior_mask()
    bnd = ~interior
    I = da.dof_index(xi[interior], yi[interior])
    ii = [da.dof_index(xi[bnd], yi[bnd]), I]
    jj = [da.dof_index(xi[bnd], yi[bnd]), I]
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ii.append(I)
        jj.append(da.dof_index(xi[interior] + dx, yi[interior] + dy))
    return np.concatenate(ii), np.concatenate(jj), interior


def make_jacobian(da, lam):
    """The FormJacobianLocal callback: ex5.c's entries at the iterate, the
    u-dependent diagonal computed on the iterate's device."""
    nx, ny = da.sizes
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    sc = hx * hy * lam
    hxdhy, hydhx = hx / hy, hy / hx
    ii, jj, interior = jacobian_pattern(da)
    nb, ni = int((~interior).sum()), int(interior.sum())
    cache = {}

    def jacobian(snes, X, J, P):
        u = X.array
        dev = u.device
        st = cache.get(dev)
        if st is None:
            st = cache[dev] = {
                "interior": torch.as_tensor(np.nonzero(interior)[0], device=dev),
                "const": torch.as_tensor(np.concatenate(
                    [np.full(ni, v) for v in (-hydhx, -hydhx, -hxdhy, -hxdhy)]),
                    dtype=u.dtype, device=dev),
                "ones": torch.ones(nb, dtype=u.dtype, device=dev)}
        diag = 2.0 * (hydhx + hxdhy) - sc * torch.exp(u[st["interior"]])
        P.setPreallocationCOO(ii, jj)
        P.setValuesCOO(torch.cat([st["ones"], diag, st["const"]]))

    return jacobian


def initial_guess(da, lam):
    """ex5.c's FormInitialGuess: lam/(lam+1) sqrt of the distance to the
    boundary, 0 on it."""
    nx, ny = da.sizes
    xy = da.node_coords()
    xi, yi = xy[:, 0], xy[:, 1]
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    g = lam / (lam + 1.0) * np.sqrt(np.minimum(np.minimum(xi, nx - 1 - xi) * hx,
                                               np.minimum(yi, ny - 1 - yi) * hy))
    g[(xi == 0) | (xi == nx - 1) | (yi == 0) | (yi == ny - 1)] = 0.0
    return g


def main(argv=None, device=None):
    """Solve on a 4 x 4 DMDA (or -da_grid_x|y), print the iterations,
    return (snes, x). The card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    lam = pt.options().get_real("par", default=6.0)
    da = pt.DMDA.create(2, (4, 4), dof=1, stencil_width=1)
    da.setFromOptions()

    snes = pt.SNES().create()
    snes.setDM(da)
    snes.setFunction(make_residual(da, lam))
    J = da.createMatrix()
    snes.setJacobian(make_jacobian(da, lam), J=J)

    x = da.createGlobalVector()
    x.setArray(initial_guess(da, lam))
    snes.setFromOptions()
    snes.solve(None, x)
    print(f"Number of SNES iterations = {snes.getIterationNumber()}")
    return snes, x


if __name__ == "__main__":
    main()
