#!/usr/bin/env python3
"""The reference's contract for PETSc's ex56 (3-D Q1 elasticity, block
size 3, six rigid-body modes): the JAX package (petsc_tpu) on the CPU,
float64, with the options chip_smoke.py passes on the card.

    python ex56_contract.py NE [defaults|knobs|transposed]

The problem is examples/ex56.py's: NE^3 hexahedral elements, a soft
inclusion (alpha 1e-3), ``assemble(NE)`` as MatAIJ.from_scipy with
``setBlockSize(3)`` and the rigid-body modes as the near-nullspace in
``MatNullSpace.createRigidBody``'s column order (what PETSc's ex56.c and
the port's example pass; examples/ex56.py's ``rigid_body_modes`` orders
the rotations otherwise), CG in the unpreconditioned norm to rtol 1e-4.
Modes:

* defaults: ``-ksp_type cg -pc_type gamg``, every GAMG option at its
  default;
* knobs: the knob set of PETSc's ex56 test (tests/test_parity_gamg.py
  EX56_REF_ARGS: HEM, strength index 1,2, threshold .001, the
  aggregate-block smoother with exact sub-solves, Chebyshev(1) with esteig
  0,0.2,0,1.05, a CG+Jacobi coarse solve);
* transposed: the knob set with the rotations evaluated at each node's
  x <-> z transposed twin, what PETSc's ex56.c program passes.

Prints one JSON line: its, reason, the residual history, the final
residual norm, the true relative residual ||b - A x|| / ||b||, each
level's rows, aggregate count and Chebyshev bound, the SHA-256 of the
level-0 aggregate array (int64 bytes), seconds and peak memory. NE 11
takes seconds; NE 64 (823,875 rows, 64,701,513 entries) some minutes and
tens of GB. Not a test, and not part of the port: it imports jax.
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

import petsc_tpu as pt  # noqa: E402
from examples import ex56  # noqa: E402

KNOBS = [
    "-alpha", "1e-3", "-ksp_type", "cg", "-pc_type", "gamg",
    "-pc_gamg_agg_nsmooths", "1", "-mg_levels_ksp_max_it", "1",
    "-mg_levels_ksp_type", "chebyshev", "-mg_levels_ksp_chebyshev_esteig", "0,0.2,0,1.05",
    "-pc_gamg_asm_use_agg", "-mg_levels_sub_pc_type", "lu", "-mg_levels_pc_asm_overlap", "0",
    "-pc_gamg_mat_coarsen_type", "hem", "-pc_gamg_mat_coarsen_max_it", "5",
    "-ksp_rtol", "1e-4", "-pc_gamg_threshold", ".001",
    "-pc_gamg_mat_coarsen_strength_index", "1,2",
    "-mg_coarse_pc_type", "jacobi", "-mg_coarse_ksp_type", "cg",
]
DEFAULTS = ["-ksp_type", "cg", "-pc_type", "gamg"]


def main():
    ne = int(sys.argv[1])
    mode = sys.argv[2] if len(sys.argv) > 2 else "defaults"
    # examples/ex56.py main(), keeping x for the true residual
    pt.init(args=["-ne", str(ne)] + (DEFAULTS if mode == "defaults" else KNOBS))
    t0 = time.perf_counter()
    A_sp, b_np, coords = ex56.assemble(ne, 1e-3)
    A = pt.MatAIJ.from_scipy(A_sp)
    A.setBlockSize(3)
    # the rigid-body modes PETSc's ex56.c passes (MatNullSpaceCreateRigidBody:
    # rotations about x, y, z), given as the array: GAMG reads the
    # MatNullSpace object's empty .vectors and fails (ROADMAP section 3)
    c = coords[:, ::-1].copy() if mode == "transposed" else coords
    A.setNearNullSpace(pt.MatNullSpace.createRigidBody(c)._dense)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setNormType("unpreconditioned")
    ksp.setTolerances(rtol=1e-4, max_it=200)
    ksp.setFromOptions()
    b = pt.Vec.from_array(b_np)
    x = A.createVecRight()
    ksp.solve(b, x)
    seconds = time.perf_counter() - t0
    xh = np.asarray(x.getArray())[: A_sp.shape[0]]
    levels = ksp.getPC()._impl.levels
    agg0 = levels[0].agg
    print(json.dumps({
        "ne": ne, "mode": mode, "rows": int(A_sp.shape[0]), "nnz": int(A_sp.nnz),
        "its": int(ksp.getIterationNumber()), "reason": ksp.getConvergedReason().name,
        "history": [float(h) for h in ksp.getConvergenceHistory()],
        "rnorm": float(ksp.getResidualNorm()),
        "true_relres": float(np.linalg.norm(b_np - A_sp @ xh) / np.linalg.norm(b_np)),
        "level_rows": [int(lev.A.getSize()[0]) for lev in levels],
        "level_aggs": [None if lev.agg is None else int(lev.agg.max()) + 1 for lev in levels],
        "level_emax": [lev.emax for lev in levels],
        "agg0_sha256": None if agg0 is None else
        hashlib.sha256(np.asarray(agg0, dtype=np.int64).tobytes()).hexdigest(),
        "seconds": seconds,
        "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}))


if __name__ == "__main__":
    main()
