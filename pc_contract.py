#!/usr/bin/env python3
"""The reference's contract for chip_smoke.py's phase pc: the JAX package
(petsc_tpu) on the CPU, float64, with the options chip_smoke.py passes on
the card.

    python pc_contract.py [--write] [CASE ...]

Each case of chip_smoke.PC_CASES (or the CASEs given) is solved on its
operator: config 2's stencil7 as MatAIJ.from_scipy (b = A cos(0.01 i)), the
same after setStencilGrid, the 128^3 box27 as MatAIJ.from_scipy (b = 1),
PETSc's ex56 at ne 64 (examples/ex56.py, setBlockSize(3), CG in the
unpreconditioned norm) and the ex59-class Q1 Poisson MatIS built by
petsc_tpu_torch.ops.stencil_build.matis_poisson (numpy, no jax), with
chip_smoke.PC_RTOL and PC_MAX_IT. Prints one JSON line per case: its,
reason, the residual history, the final residual norm, the true relative
residual, seconds and peak memory; --write merges them into
tests/data/pc_contract.json. Not a test, and not part of the port: it
imports jax. The box cases take minutes each and about 10 GB; the MatIS
cases hold two 2.43 GB tables.
"""

import json
import resource
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import chip_smoke  # noqa: E402
import petsc_tpu as pt  # noqa: E402
from petsc_tpu.mat.utility import MatIS  # noqa: E402
from petsc_tpu_torch.ops.stencil_build import matis_poisson, stencil7_coo  # noqa: E402

OUT = Path(__file__).resolve().parent / "tests" / "data" / "pc_contract.json"


def operator(group):
    """(Mat, b, the host CSR) of an operator group."""
    if group.startswith("config2"):
        i, j, v = stencil7_coo(*chip_smoke.CONFIG2)
        n = int(np.prod(chip_smoke.CONFIG2))
        A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
        A = pt.MatAIJ.from_scipy(A_sp)
        if group == "config2_grid":
            A.setStencilGrid(chip_smoke.CONFIG2)
        return A, A_sp @ np.cos(0.01 * np.arange(n)), A_sp
    if group == "box":
        N = chip_smoke.KRYLOV_BOX_N
        bi, bj, bv = chip_smoke.box27_coo(N)
        A_sp = sp.csr_matrix((bv, (bi, bj)), shape=(N ** 3, N ** 3))
        return pt.MatAIJ.from_scipy(A_sp), np.ones(N ** 3), A_sp
    if group == "ex56":
        from examples import ex56
        A_sp, b_np, _ = ex56.assemble(64, 1e-3)
        A = pt.MatAIJ.from_scipy(A_sp)
        A.setBlockSize(3)
        return A, b_np, A_sp
    ne, nsub = chip_smoke.PC_MATIS if group == "matis" else chip_smoke.PC_MATIS_NN
    mats, maps, n = matis_poisson(ne, nsub)
    M = MatIS.create(n, mats, maps)
    rows, cols, vals = [], [], []
    for Ai, gi in zip(mats, maps):
        c = sp.coo_matrix(Ai)
        rows.append(gi[c.row])
        cols.append(gi[c.col])
        vals.append(c.data)
    A_sp = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))
    return M, chip_smoke.pc_rhs_matis(n), A_sp


def run(case):
    group, args = chip_smoke.PC_CASES[case]
    t0 = time.perf_counter()
    pt.init(args=[*args, "-ksp_rtol", str(chip_smoke.PC_RTOL[group]), "-ksp_max_it",
                  str(chip_smoke.PC_MAX_IT[group])])
    A, b_np, A_sp = operator(group)
    setup_op = time.perf_counter() - t0
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    if group == "ex56":
        ksp.setNormType("unpreconditioned")
    ksp.setFromOptions()
    x = A.createVecRight()
    t0 = time.perf_counter()
    ksp.solve(pt.Vec.from_array(b_np), x)
    xh = np.asarray(x.getArray())[: len(b_np)]
    out = {"case": case, "group": group, "ksp_type": ksp.getType(),
           "pc_type": ksp.getPC().getType(), "its": int(ksp.getIterationNumber()),
           "reason": ksp.getConvergedReason().name,
           "history": [float(h) for h in ksp.getConvergenceHistory()],
           "rnorm": float(ksp.getResidualNorm()),
           "true_relres": float(np.linalg.norm(b_np - A_sp @ xh) / np.linalg.norm(b_np)),
           "operator_s": setup_op, "seconds": time.perf_counter() - t0,
           "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
    print(json.dumps(out), flush=True)
    return out


def main():
    argv = sys.argv[1:]
    write = "--write" in argv
    cases = [a for a in argv if a != "--write"] or list(chip_smoke.PC_CASES)
    got = {c: run(c) for c in cases}
    if write:
        old = json.loads(OUT.read_text()) if OUT.exists() else {}
        old.update(got)
        OUT.write_text(json.dumps(old, indent=1) + "\n")


if __name__ == "__main__":
    main()
