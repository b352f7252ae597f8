"""Driven cavity: the velocity-vorticity formulation with buoyancy.

The port's copy of ``examples/ex19.py``, the analog of PETSc's
src/snes/tutorials/ex19.c (the 2-D driven cavity, 4 dof a node (u, v,
omega, T), upwinded convection, lid velocity 1/(mx my), Newton on a
DMDA). The residual is one torch function of the (my, mx, 4) state built
from array shifts (four rolls of the whole state): the interior stencils,
the upwind selects and the four boundary closures as masked overwrites
(``torch.where``), all out of place, so ``torch.func`` and autograd carry
its derivatives (the Jacobian action is exact). The
Newton solve is JFNK (``setUseMF``) preconditioned by the FD-colouring
Jacobian of the DMDA's stencil pattern.

    python -m petsc_tpu_torch.examples.ex19 -da_refine 3 -snes_monitor_short
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import petsc_tpu_torch as pt


def make_residual(mx, my, lid, prandtl, grashof):
    """The pure residual F(X) of the flat (my mx 4,) state."""
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hxdhy, hydhx = hx * dhy, hy * dhx
    masks = {}

    def edges(dev):
        m = masks.get(dev)
        if m is None:
            jj = torch.arange(my, device=dev)[:, None]
            ii = torch.arange(mx, device=dev)[None, :]
            m = masks[dev] = tuple(e.expand(my, mx)[..., None] for e in
                                   (jj == 0, jj == my - 1, ii == 0, ii == mx - 1))
        return m

    def residual(xflat):
        X = xflat.reshape(my, mx, 4)
        u, v, om, T = X.unbind(-1)
        # the four neighbours of every field at once: nb[k][..., c] is field
        # c shifted so that out[j, i] = a[j + dj, i + di] (wrapped; only
        # interior values are used)
        nb = {d: torch.roll(X, shifts=(-d[0], -d[1]), dims=(0, 1)).unbind(-1)
              for d in ((0, -1), (0, 1), (-1, 0), (1, 0))}
        W, E, S, N = nb[(0, -1)], nb[(0, 1)], nb[(-1, 0)], nb[(1, 0)]

        vxp = 0.5 * (u + torch.abs(u))
        vxm = 0.5 * (u - torch.abs(u))
        vyp = 0.5 * (v + torch.abs(v))
        vym = 0.5 * (v - torch.abs(v))

        def lap(c):
            a = X[..., c]
            return ((2.0 * a - W[c] - E[c]) * hydhx + (2.0 * a - S[c] - N[c]) * hxdhy)

        def upwind(c):
            a = X[..., c]
            return ((vxp * (a - W[c]) + vxm * (E[c] - a)) * hy
                    + (vyp * (a - S[c]) + vym * (N[c] - a)) * hx)

        fu = lap(0) - 0.5 * (N[2] - S[2]) * hx
        fv = lap(1) + 0.5 * (E[2] - W[2]) * hy
        fo = lap(2) + upwind(2) - 0.5 * grashof * (E[3] - W[3]) * hy
        ft = lap(3) + prandtl * upwind(3)
        F = torch.stack([fu, fv, fo, ft], dim=-1)

        # the boundary closures (ex19.c's edge branches)
        bot, top, left, right = edges(xflat.device)
        Fb = torch.stack([u, v, om + (N[0] - u) * dhy, T - N[3]], dim=-1)
        Ft = torch.stack([u - lid, v, om + (u - S[0]) * dhy, T - S[3]], dim=-1)
        Fl = torch.stack([u, v, om - (E[1] - v) * dhx, T], dim=-1)
        Fr = torch.stack([u, v, om - (v - W[1]) * dhx,
                          T - (1.0 if grashof > 0 else 0.0)], dim=-1)
        # ex19.c's order: bottom, top, then left and right, which own the
        # corners
        F = torch.where(bot, Fb, F)
        F = torch.where(top, Ft, F)
        F = torch.where(left, Fl, F)
        F = torch.where(right, Fr, F)
        return F.reshape(-1)

    return residual


def initial_guess(mx, my, grashof):
    """FormInitialGuess: a motionless fluid, the linear equilibrium T."""
    X = np.zeros((my, mx, 4))
    if grashof > 0:
        X[..., 3] = (np.arange(mx) * (1.0 / (mx - 1)))[None, :]
    return X.reshape(-1)


def main(argv=None, device=None):
    """Solve on a 4 x 4 DMDA refined by -da_refine; return (snes, x,
    (mx, my)). The card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    opts = pt.options()
    da = pt.DMDA.create(dim=2, sizes=(4, 4), dof=4, stencil_type="star")
    da.setFromOptions()
    mx, my = da.sizes
    lid = opts.get_real("lidvelocity", default=1.0 / (mx * my))
    prandtl = opts.get_real("prandtl", default=1.0)
    grashof = opts.get_real("grashof", default=1.0)

    def pg(v):
        # PETSc's %g prints a trailing "." on integral values (1 -> "1.")
        t = f"{v:g}"
        return t + "." if t.lstrip("-").isdigit() else t

    print(f"lid velocity = {pg(lid)}, prandtl # = {pg(prandtl)}, "
          f"grashof # = {pg(grashof)}")

    snes = pt.SNES().create()
    snes.setDM(da)
    snes.setFunction(make_residual(mx, my, lid, prandtl, grashof))
    snes.setUseMF(True)
    snes.setFromOptions()
    x = pt.Vec.from_array(initial_guess(mx, my, grashof))
    snes.solve(None, x)
    print(f"Number of SNES iterations = {snes.getIterationNumber()}")
    return snes, x, (mx, my)


if __name__ == "__main__":
    main()
