"""The 2-D heat equation u_t = Laplacian(u) on a DMDA grid with TS.

The port's copy of ``examples/heat.py`` (the role of PETSc's TS tutorials,
src/ts/tutorials/ex3.c): a pure torch right-hand side over the grid,
written out of place (the interior Laplacian padded back with zeros on
the Dirichlet boundary), implicit theta methods with exact JVP stage
Jacobians, held against the analytic decay of the sin(pi x) sin(pi y)
mode.

    python -m petsc_tpu_torch.examples.heat -da_grid_x 33 -da_grid_y 33 \\
        -ts_type cn -ts_dt 0.001 -ts_max_time 0.02 -ts_monitor
"""

from __future__ import annotations

import sys

import numpy as np
import torch.nn.functional as tF

import petsc_tpu_torch as pt


def make_rhs(da):
    """du/dt = Laplacian u with homogeneous Dirichlet boundaries."""
    nx, ny = da.sizes
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)

    def rhs(t, u_flat):
        u = u_flat.reshape(ny, nx)
        lap = (u[1:-1, :-2] - 2 * u[1:-1, 1:-1] + u[1:-1, 2:]) / hx ** 2 \
            + (u[:-2, 1:-1] - 2 * u[1:-1, 1:-1] + u[2:, 1:-1]) / hy ** 2
        return tF.pad(lap, (1, 1, 1, 1)).reshape(-1)

    return rhs


def main(argv=None, device=None):
    """Integrate on a 33 x 33 DMDA (or -da_grid_x|y); print the decay of
    the centre value against the analytic one; return (ts, ratio, exact).
    The card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    opts = pt.options()
    da = pt.DMDA.create(2, (33, 33))
    da.setFromOptions()
    nx, ny = da.sizes

    ts = pt.TS().create()
    ts.setType(opts.get_string("ts_type", default="cn"))
    ts.setRHSFunction(make_rhs(da))
    ts.setTimeStep(opts.get_real("ts_dt", default=1e-3))
    ts.setMaxTime(opts.get_real("ts_max_time", default=0.02))
    ts.adapt.kind = opts.get_string("ts_adapt_type", default="none")

    xs = np.linspace(0, 1, nx)
    ys = np.linspace(0, 1, ny)
    X, Y = np.meshgrid(xs, ys)
    u0 = np.sin(np.pi * X) * np.sin(np.pi * Y)
    u = da.createGlobalVector()
    u.setArray(u0.reshape(-1))
    ts.solve(u)

    # analytic: u(t) = exp(-2 pi^2 t) u0 (the continuum rate; the FD rate
    # differs at O(h^2))
    lam = 2.0 * np.pi ** 2
    uT = np.asarray(u.getArray()).reshape(ny, nx)
    ratio = uT[ny // 2, nx // 2] / u0[ny // 2, nx // 2]
    exact = np.exp(-lam * ts.getTime())
    print(f"steps {ts.getStepNumber()} t={ts.getTime():g} "
          f"decay={ratio:.6f} exact={exact:.6f} "
          f"relerr={abs(ratio - exact) / exact:.2e}")
    return ts, ratio, exact


if __name__ == "__main__":
    main()
