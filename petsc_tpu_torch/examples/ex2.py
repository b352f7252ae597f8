"""Solve the 2-D 5-point Poisson system with KSP.

The port's copy of ``examples/ex2.py``, the analog of PETSc's
src/ksp/ksp/tutorials/ex2.c: the same matrix (natural ordering,
ADD_VALUES stencil assembly), the same exact solution (all ones), the same
default tolerances (rtol = 1e-2 / ((m + 1)(n + 1))) and the same output,
so the reference's expected outputs (output/ex2_*.out) compare with it.

    python -m petsc_tpu_torch.examples.ex2 -m 5 -n 5 -ksp_monitor_short
"""

from __future__ import annotations

import sys

import petsc_tpu_torch as pt
from petsc_tpu_torch.vec.vec import InsertMode


def main(argv=None, device=None):
    """Returns (the error norm, the iterations). The card unless
    device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    opts = pt.options()
    m = opts.get_int("m", default=8)
    n = opts.get_int("n", default=7)

    A = pt.MatAIJ()
    A.setSizes((m * n, m * n))
    for Ii in range(m * n):
        i, j = Ii // n, Ii % n
        if i > 0:
            A.setValue(Ii, Ii - n, -1.0, InsertMode.ADD_VALUES)
        if i < m - 1:
            A.setValue(Ii, Ii + n, -1.0, InsertMode.ADD_VALUES)
        if j > 0:
            A.setValue(Ii, Ii - 1, -1.0, InsertMode.ADD_VALUES)
        if j < n - 1:
            A.setValue(Ii, Ii + 1, -1.0, InsertMode.ADD_VALUES)
        A.setValue(Ii, Ii, 4.0, InsertMode.ADD_VALUES)
    A.assemblyBegin()
    A.assemblyEnd()
    A.setOption("symmetric", True)

    u = A.createVecRight()
    u.set(1.0)
    b = A.createVecLeft()
    A.mult(u, b)

    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setTolerances(rtol=1.e-2 / ((m + 1) * (n + 1)), atol=1.e-50)
    ksp.setFromOptions()
    x = A.createVecRight()
    ksp.solve(b, x)

    x.axpy(-1.0, u)
    norm = x.norm()
    its = ksp.getIterationNumber()
    print(f"Norm of error {norm:g} iterations {its}")
    return norm, its


if __name__ == "__main__":
    main()
