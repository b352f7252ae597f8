"""Solve a tridiagonal system, then solve again after a MatShift.

The port's copy of ``examples/ex1.py``, the analog of PETSc's
src/ksp/ksp/tutorials/ex1.c: the 1-D Laplacian (-1, 2, -1), exact
solution u = 1, GMRES + Jacobi to rtol 1e-5; the second solve checks that
new matrix values reach the solver (the Mat's state counter). Expected
output: the reference's output/ex1_1.out.

    python -m petsc_tpu_torch.examples.ex1 -ksp_monitor_short
"""

from __future__ import annotations

import sys

import numpy as np

import petsc_tpu_torch as pt


def main(argv=None, device=None):
    """The card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    opts = pt.options()
    n = opts.get_int("n", default=10)

    A = pt.MatAIJ(None)
    A.setSizes((n, n))
    for i in range(1, n - 1):
        A.setValues([i], [i - 1, i, i + 1], [[-1.0, 2.0, -1.0]])
    A.setValues([0], [0, 1], [[2.0, -1.0]])
    A.setValues([n - 1], [n - 2, n - 1], [[-1.0, 2.0]])
    A.assemble()

    u = pt.Vec.from_array(np.ones(n))
    b = A.createVecLeft()
    A.mult(u, b)

    ksp = pt.KSP().create()
    ksp.setOperators(A, A)
    ksp.getPC().setType("jacobi")
    ksp.setTolerances(rtol=1.e-5)
    ksp.setFromOptions()

    x = A.createVecRight()
    ksp.solve(b, x)

    x.axpy(-1.0, u)
    norm = float(x.norm())
    its = ksp.getIterationNumber()
    print(f"Norm of error {norm:g}, Iterations {its}")

    # new values must reach the solver (the state counter)
    A.shift(2.0)
    x2 = A.createVecRight()
    ksp.solve(b, x2)
    return ksp


if __name__ == "__main__":
    main()
