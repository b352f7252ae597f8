#!/usr/bin/env python3
"""The reference's contract for CG + GAMG on assembled box27: the JAX
package (petsc_tpu) on the CPU, float64, with the options chip_smoke.py
passes on the card.

    python gamg_contract.py N [f64|f32] [grid]

The operator is the 27-point box (26 / -1, Dirichlet truncation) on an
N^3 grid as MatAIJ.from_scipy, no grid declared (so the whole hierarchy
comes from aggregation); with `grid` it is the stencil operator of
bench.py's solve instead, build_dnd((N,)*3, kind="box") wrapped by
as_mat, whose declared grid sends PCGAMG through the structured device
head (Q1 levels probed on the device down to the structured limit, then
aggregation on the tail). CG with -pc_type gamg to rtol 1e-8, b = 1,
x0 = 0, every GAMG option at its default: MIS-2 with the square fix on
level 0 and MIS above, threshold -1, one smoothing of the prolongator,
coarse limit 50, Chebyshev(2, 2) with Jacobi, a V-cycle and a dense LU on
the coarsest level. f32 adds -pc_mg_dtype single. Prints one JSON line:
its, reason, the residual history, the true relative residual, each
level's rows, nnz of A and of P, aggregate count (null on a structured
level) and Chebyshev bound, each level's A and P kinds, the SHA-256 of
the level-0 aggregate array (int64 bytes; null when level 0 is
structured), seconds and peak memory. At N = 128 it takes about 2 minutes and 10 GB. Not a test, and
not part of the port: it imports jax.
"""

import hashlib
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
    grid = len(sys.argv) > 3 and sys.argv[3] == "grid"
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"]
    if grid:
        args += ["-ksp_max_it", "60"]       # bench.py's solve
    if cycle == "f32":
        args += ["-pc_mg_dtype", "single"]
    pt.init(args=args)
    t0 = time.perf_counter()
    i, j, v = chip_smoke.box27_coo(n)
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n ** 3, n ** 3))
    if grid:
        from petsc_tpu.ops import stencil_build
        A = stencil_build.as_mat(*stencil_build.build_dnd((n,) * 3, kind="box"))
    else:
        A = pt.MatAIJ.from_scipy(A_sp)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    xs = np.asarray(x.getArray())[: n ** 3]
    levels = ksp.getPC()._impl.levels
    print(json.dumps({
        "n": n, "cycle": cycle, "operator": "build_dnd + as_mat" if grid else "MatAIJ",
        "jax": jax.__version__, "its": ksp.getIterationNumber(),
        "reason": ksp.getConvergedReason().name, "rnorm": ksp.getResidualNorm(),
        "history": [float(h) for h in ksp.getConvergenceHistory()],
        "true_relres": float(np.linalg.norm(1.0 - A_sp @ xs) / np.sqrt(n ** 3)),
        "level_rows": [lev.A.getSize()[0] for lev in levels],
        "level_nnz": [lev.A.nnz() for lev in levels],
        "level_P_nnz": [int(lev.P.to_scipy().nnz) for lev in levels[:-1]],
        "level_aggregates": [None if lev.agg is None else int(lev.agg.max()) + 1
                             for lev in levels[:-1]],
        "level_emax": [lev.emax for lev in levels[:-1]],
        "level_A_kind": [lev.A.meta[0] for lev in levels],
        "level_P_kind": [lev.P.meta[0] for lev in levels[:-1]],
        "agg0_sha256": None if levels[0].agg is None else hashlib.sha256(
            np.asarray(levels[0].agg, dtype=np.int64).tobytes()).hexdigest(),
        "seconds": time.perf_counter() - t0,
        "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}))


if __name__ == "__main__":
    main()
