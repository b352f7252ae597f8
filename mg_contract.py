#!/usr/bin/env python3
"""The reference's contract for CG + PCMG on assembled box27: the JAX
package (petsc_tpu) on the CPU, float64, with the hierarchy chip_smoke.py
drives on the card.

    python mg_contract.py N [f64|f32]

The operator is the 27-point box (26 / -1, Dirichlet truncation) on an
N^3 grid as MatAIJ.from_scipy; CG with -pc_type mg to rtol 1e-8, b = 1,
x0 = 0; setLevels and setInterpolation(l, kron(P1, P1, P1)) on the grids
N, N/2, ... down to 8 (chip_smoke.q1_hierarchy); everything else the
default: Galerkin coarse operators, Chebyshev(2, 2) with Jacobi, host
bounds through the (0, 0.1, 0, 1.1) transform, a V-cycle, a dense LU on
the coarsest level. f32 adds -pc_mg_dtype single. Prints one JSON line:
its, reason, the residual history, the true relative residual, each
level's nnz and bound, seconds and peak memory. At N = 128 it takes about
40 s and 5 GB. Not a test, and not part of the port: it imports jax.
"""

import json
import resource
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import chip_smoke  # noqa: E402
import petsc_tpu as pt  # noqa: E402


def main():
    n = int(sys.argv[1])
    cycle = sys.argv[2] if len(sys.argv) > 2 else "f64"
    args = ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8"]
    if cycle == "f32":
        args += ["-pc_mg_dtype", "single"]
    pt.init(args=args)
    t0 = time.perf_counter()
    i, j, v = chip_smoke.box27_coo(n)
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n ** 3, n ** 3))
    A = pt.MatAIJ.from_scipy(A_sp)
    _, Ps = chip_smoke.q1_hierarchy(n)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    mg = ksp.getPC()._impl
    mg.setLevels(len(Ps) + 1)
    for l, P in enumerate(Ps):
        mg.setInterpolation(l, pt.MatAIJ.from_scipy(P))
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    xs = np.asarray(x.getArray())[: n ** 3]
    print(json.dumps({
        "n": n, "cycle": cycle, "its": ksp.getIterationNumber(),
        "reason": ksp.getConvergedReason().name, "rnorm": ksp.getResidualNorm(),
        "history": [float(h) for h in ksp.getConvergenceHistory()],
        "true_relres": float(np.linalg.norm(1.0 - A_sp @ xs) / np.sqrt(n ** 3)),
        "level_nnz": [lev.A.nnz() for lev in mg.levels],
        "level_emax": [lev.emax for lev in mg.levels],
        "seconds": time.perf_counter() - t0,
        "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}))


if __name__ == "__main__":
    main()
