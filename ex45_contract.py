#!/usr/bin/env python3
"""The reference's contract for PETSc's ex45 (the 3-D Laplacian on a
DMDA): the JAX package (petsc_tpu) on the CPU, float64, with the options
chip_smoke.py passes on the card.

    python ex45_contract.py N [mg|gamg|dof3]

* mg, gamg: examples/ex45.py's steps at -da_grid_x|y|z N, -ksp_type cg
  -ksp_rtol 1e-8 and -pc_type mg (PCMG from the DM, each coarse level
  rediscretized by the compute_operators callback) or -pc_type gamg;
* dof3: a DMDA of 3 components per node, each component the same 7-point
  operator as ex45's (the components decoupled; ``component_laplacian`` of
  the port's examples/ex45.py, numpy over the DMDA's indices), assembled by COO into da.createMatrix() and given to
  KSP.setOperators with no callback, so that PCMG from the DM takes
  Galerkin coarse operators; b = 1, CG to rtol 1e-8.

Prints one JSON line: its, reason, the residual history, the final
residual norm, the true relative residual ||b - A x|| / ||b||, each
level's rows, operator kind and Chebyshev bound, seconds and peak memory.
N 17 takes seconds; N 129 about a minute and some GB. Not a test, and not
part of the port: it imports jax.
"""

import json
import resource
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import petsc_tpu as pt  # noqa: E402
from examples import ex45  # noqa: E402
# numpy only: the dof-3 problem's COO triplets on the reference's DMDA
from petsc_tpu_torch.examples.ex45 import component_laplacian  # noqa: E402

ARGS = ["-ksp_type", "cg", "-ksp_rtol", "1e-8"]


def main():
    n = int(sys.argv[1])
    mode = sys.argv[2] if len(sys.argv) > 2 else "mg"
    grid = ["-da_grid_x", str(n), "-da_grid_y", str(n), "-da_grid_z", str(n)]
    t0 = time.perf_counter()
    if mode == "dof3":
        pt.init(args=ARGS + ["-pc_type", "mg"])
        da = pt.DMDA.create(3, (n, n, n), dof=3, stencil_width=1)
        A = da.createMatrix()
        i, j, v = component_laplacian(da)
        A.setPreallocationCOO(i, j)
        A.setValuesCOO(v)
        ksp = pt.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        b = A.createVecLeft()
        b.set(1.0)
        x = ksp.solve(b)
    else:
        ksp = ex45.main(grid + ARGS + ["-pc_type", mode])
        A = ksp.mat
        b = ksp.getDM().createGlobalVector()
        ex45.compute_rhs(ksp, b)
        x = ksp.getSolution()
    seconds = time.perf_counter() - t0
    A_sp = A.to_scipy()
    bh = np.asarray(b.getArray())[: A_sp.shape[0]]
    xh = np.asarray(x.getArray())[: A_sp.shape[0]]
    levels = ksp.getPC()._impl.levels
    print(json.dumps({
        "n": n, "mode": mode, "rows": int(A_sp.shape[0]), "nnz": int(A_sp.nnz),
        "kind": A.meta[0],
        "its": int(ksp.getIterationNumber()), "reason": ksp.getConvergedReason().name,
        "history": [float(h) for h in ksp.getConvergenceHistory()],
        "rnorm": float(ksp.getResidualNorm()),
        "true_relres": float(np.linalg.norm(bh - A_sp @ xh) / np.linalg.norm(bh)),
        "level_rows": [int(lev.A.getSize()[0]) for lev in levels],
        "level_kinds": [lev.A.meta[0] for lev in levels],
        "level_emax": [lev.emax for lev in levels],
        "seconds": seconds,
        "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}))


if __name__ == "__main__":
    main()
