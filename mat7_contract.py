#!/usr/bin/env python3
"""The reference's contract for the wrapper-Mat solves of chip_smoke.py's
phases maij_kaij and mat_shell_dense: the JAX package (petsc_tpu) on the
CPU, float64, with the options chip_smoke.py passes on the card.

    python mat7_contract.py N maij|kaij|matsolve

The operator is the 27-point box (26 / -1, Dirichlet truncation) on an
N^3 grid, assembled as MatAIJ.from_scipy (maij, kaij) or the stencil
operator of bench.py's solve (matsolve). Modes:

* maij: MatMAIJ.create(A, 3) (I_3 (x) A, node-major), CG with -pc_type
  none to rtol 1e-8, x0 = 0, b's three components 1, cos(0.01 i) and
  sin(0.01 i) at node i (chip_smoke.maij_rhs);
* kaij: one Radau IIA 3-stage stage system as TSIRK builds it with
  MatKAIJ, K = I_N (x) I_3 + A (x) (dt A_RadauIIA), dt = 0.01
  (chip_smoke.radau_iia3), GMRES(30) with -pc_type none to rtol 1e-8,
  b = 1, x0 = 0 (6,291,456 unknowns at N = 128);
* matsolve: CG + GAMG with the structured head, f64 cycle, rtol 1e-8,
  max_it 60, on build_dnd((N,)*3, "box") + as_mat, one ksp.solve per
  column of chip_smoke.matsolve_rhs (column 0 is b = 1, columns 1-3
  cos(0.01 (i + c))), each from zero: what the card's matSolve gives per
  column.

Prints one JSON line per solve: its, reason, the residual history, the
true relative residual, seconds and peak memory. Not a test, and not part
of the port: it imports jax.
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


def solve(A, b, args, true_op):
    pt.init(args=args)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    x = A.createVecRight()
    t0 = time.perf_counter()
    ksp.solve(pt.Vec.from_array(b), x)
    xs = np.asarray(x.getArray())[: len(b)]
    return {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
            "history": [float(h) for h in ksp.getConvergenceHistory()],
            "true_relres": float(np.linalg.norm(b - true_op(xs)) / np.linalg.norm(b)),
            "seconds": time.perf_counter() - t0,
            "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}


def main():
    n, mode = int(sys.argv[1]), sys.argv[2]
    N = n ** 3
    out = {"n": n, "mode": mode, "jax": jax.__version__}
    if mode in ("maij", "kaij"):
        pt.init()
        i, j, v = chip_smoke.box27_coo(n)
        A_sp = sp.csr_matrix((v, (i, j)), shape=(N, N))
        del i, j, v
        A = pt.MatAIJ.from_scipy(A_sp)
        out["A_kind"] = A.meta[0]
        if mode == "maij":
            from petsc_tpu.mat.utility import MatMAIJ
            M = MatMAIJ.create(A, 3)
            rec = solve(M, chip_smoke.maij_rhs(N),
                        ["-ksp_type", "cg", "-pc_type", "none", "-ksp_rtol", "1e-8",
                         "-ksp_max_it", "3000"],
                        lambda x: (A_sp @ x.reshape(N, 3)).reshape(-1))
        else:
            from petsc_tpu.mat.extra_formats import MatKAIJ
            T = chip_smoke.KAIJ_DT * chip_smoke.radau_iia3()
            K = MatKAIJ.create(A, np.eye(3), T)
            rec = solve(K, np.ones(3 * N),
                        ["-ksp_type", "gmres", "-pc_type", "none", "-ksp_rtol", "1e-8",
                         "-ksp_max_it", "3000"],
                        lambda x: (x.reshape(N, 3) + (A_sp @ x.reshape(N, 3)) @ T.T)
                        .reshape(-1))
        out.update(rec)
        print(json.dumps(out), flush=True)
        return
    if mode != "matsolve":
        raise SystemExit(f"mat7_contract: unknown mode {mode}")
    from petsc_tpu.ops import stencil_build
    i, j, v = chip_smoke.box27_coo(n)
    A_sp = sp.csr_matrix((v, (i, j)), shape=(N, N))
    del i, j, v
    B = chip_smoke.matsolve_rhs(N)
    for c in range(B.shape[1]):
        pt.init()
        A = stencil_build.as_mat(*stencil_build.build_dnd((n,) * 3, kind="box"))
        rec = solve(A, B[:, c], ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
                                 "-ksp_max_it", "60"], lambda x: A_sp @ x)
        print(json.dumps({**out, "column": c, **rec}), flush=True)


if __name__ == "__main__":
    main()
