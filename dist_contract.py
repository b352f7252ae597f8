#!/usr/bin/env python3
"""The reference's contract for chip_smoke.py's phase dist: the JAX
package (petsc_tpu) on the CPU, float64, over a 4-shard make_comm on
virtual CPU devices, with the options chip_smoke.py passes on the card.

    python dist_contract.py [--write] [CASE ...]

Cases (chip_smoke.DIST_CASES; on the box27 operator, 26 / -1 with
Dirichlet truncation, b = 1, x0 = 0, rtol 1e-8, but the last):

  main_f64, main_f32  CG + GAMG on the 128^3 box27 as MatAIJ.from_scipy
                      on the sharded comm after setStencilGrid (dnd_mpi):
                      the sharded structured head, then aggregation on the
                      gathered tail; main_f32 adds -pc_mg_dtype single
  jacobi_128          CG + Jacobi on the 128^3 box27 as mpiaij
  gamg_dist_64        CG + GAMG (distributed aggregation) on the 64^3 box27
                      as mpiaij
  bjacobi_64          CG + bjacobi(ILU(0)), one block a shard, the same
  fieldsplit_16       FGMRES + fieldsplit-Schur(selfp) on the dryrun's 16^3
                      7-point Laplacian + 0.5 I, fields even / odd, b = A 1

Prints one JSON line per case (its, reason, the residual history, the
true relative residual, each level's kind and rows, each level's
Chebyshev bound, seconds, peak memory); --write merges them into
tests/data/dist_contract.json, which chip_smoke.py reads as DIST_*. Not
a test, and not part of the port: it imports jax.
"""

import json
import os
import resource
import sys
import time
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import petsc_tpu as pt  # noqa: E402
from petsc_tpu.parallel.mesh import make_comm  # noqa: E402

OUT = Path(__file__).resolve().parent / "tests" / "data" / "dist_contract.json"
NSHARDS = 4

CASES = chip_smoke.DIST_CASES


def run(case):
    n, kind, args = CASES[case]
    pt.init(args=["-ksp_rtol", "1e-8", *args])
    comm = make_comm(NSHARDS)
    t0 = time.perf_counter()
    A_sp, b_np = chip_smoke.dist_operator(n, kind)
    A = pt.MatAIJ.from_scipy(A_sp, comm=comm)
    if kind == "grid":
        A.setStencilGrid((n,) * 3)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    if kind == "fieldsplit":
        N = n ** 3
        ksp.getPC().setFieldSplitIS(("0", np.arange(0, N, 2)), ("1", np.arange(1, N, 2)))
    b = A.createVecLeft()
    b.setArray(b_np)
    x = A.createVecRight()
    ksp.solve(b, x)
    xs = np.asarray(x.getArray())[: n ** 3]
    impl = ksp.getPC()._impl
    levels = getattr(impl, "levels", None) or []
    return {
        "n": n, "operator": kind, "nshards": NSHARDS, "options": list(args),
        "A_kind": A.meta[0], "jax": jax.__version__,
        "its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
        "rnorm": ksp.getResidualNorm(),
        "history": [float(h) for h in ksp.getConvergenceHistory()],
        "true_relres": float(np.linalg.norm(b_np - A_sp @ xs) / np.linalg.norm(b_np)),
        "levels": [[lev.A.meta[0], lev.A.getSize()[0]] for lev in levels],
        "level_emax": [lev.emax for lev in levels[:-1]],
        "seconds": time.perf_counter() - t0,
        "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}


def main():
    argv = sys.argv[1:]
    write = "--write" in argv
    cases = [a for a in argv if a != "--write"] or list(CASES)
    out = {}
    for case in cases:
        out[case] = run(case)
        print(json.dumps({"case": case, **out[case]}), flush=True)
    if write:
        old = json.loads(OUT.read_text()) if OUT.exists() else {}
        old.update(out)
        OUT.write_text(json.dumps(old, indent=1) + "\n")


if __name__ == "__main__":
    main()
