#!/usr/bin/env python3
"""The reference's contract for BASELINE config 2 and its small
variants: the JAX package (petsc_tpu) on the CPU, float64, with the
options chip_smoke.py passes on the card.

    python gmres_contract.py NZ NY NX [option ...]

The operator is the atmosmodd-class 7-point stencil of BASELINE config 2
(``stencil7`` of examples/bench_spmv.py, jittered, not symmetric) on an
NZ x NY x NX grid, as MatAIJ.from_scipy; the options are -ksp_rtol 1e-8
-ksp_max_it 400 and whatever follows the grid, with no KSP or PC type
unless given, so PETSc's defaults pick GMRES(30) and ILU(0). b = A
cos(0.01 i), x0 = 0. Prints one JSON line: the types, its, reason, the
residual history, the final residual norm, the true relative residual
||b - A x|| / ||b||, max |x - cos(0.01 i)|, seconds and peak memory. At
22 239 239 (config 2, 1,256,662 rows) it takes about a minute. Not a
test, and not part of the port: it imports jax.
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

import petsc_tpu as pt  # noqa: E402
from petsc_tpu_torch.ops.stencil_build import stencil7_coo  # noqa: E402


def main():
    nz, ny, nx = (int(a) for a in sys.argv[1:4])
    pt.init(args=["-ksp_rtol", "1e-8", "-ksp_max_it", "400", *sys.argv[4:]])
    t0 = time.perf_counter()
    i, j, v = stencil7_coo(nz, ny, nx)
    n = nz * ny * nx
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
    A = pt.MatAIJ.from_scipy(A_sp)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    xs = np.cos(0.01 * np.arange(n))
    b_np = A_sp @ xs
    b = pt.Vec.from_array(b_np)
    x = A.createVecRight()
    ksp.solve(b, x)
    xh = np.asarray(x.getArray())[:n]
    print(json.dumps({
        "grid": [nz, ny, nx], "rows": n, "nnz": int(A_sp.nnz), "options": sys.argv[4:],
        "ksp_type": ksp.getType(), "pc_type": ksp.getPC().getType(),
        "its": int(ksp.getIterationNumber()), "reason": ksp.getConvergedReason().name,
        "history": [float(h) for h in ksp.getConvergenceHistory()],
        "rnorm": float(ksp.getResidualNorm()),
        "true_relres": float(np.linalg.norm(b_np - A_sp @ xh) / np.linalg.norm(b_np)),
        "max_err": float(np.max(np.abs(xh - xs))),
        "seconds": time.perf_counter() - t0,
        "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}))


if __name__ == "__main__":
    main()
