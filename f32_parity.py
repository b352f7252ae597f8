#!/usr/bin/env python3
"""Krylov parity in float32: the JAX package (petsc_tpu) and the port
(petsc_tpu_torch) on the CPU, both under -real_dtype f32, on the same
operator, options and right-hand side.

    python f32_parity.py [N ...]

For box27 on N^3 (default 12 and 16), rtol 1e-6, b = 1, x0 = 0, with
CG+Jacobi, CG+none and GMRES+ILU, prints one JSON line per solve: both
packages' iterations, reasons and history dtypes, the largest gap between
the two histories over the initial norm, and the largest gap relative to
each entry. tests/test_torch_gmres.py's F32_HIST_ATOL is set from these.
Not a test, and not part of the port: it imports jax.
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import petsc_tpu as pt_jax  # noqa: E402
import petsc_tpu_torch as ptt  # noqa: E402
from petsc_tpu_torch.ops import stencil_build  # noqa: E402


def solve(pkg, A_sp, args, b):
    if pkg is pt_jax:
        pkg.init(args=args)
    else:
        pkg.init(args=args, device="cpu")
    A = pkg.MatAIJ.from_scipy(A_sp)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.solve(pkg.Vec.from_array(b), A.createVecRight())
    return ksp


def main():
    torch.set_num_threads(1)
    sizes = [int(a) for a in sys.argv[1:]] or [12, 16]
    for n in sizes:
        A = stencil_build.poisson3d_27pt(n)
        b = np.ones(A.shape[0])
        for ksp_type, pc_type in (("cg", "jacobi"), ("cg", "none"), ("gmres", "ilu")):
            args = ["-ksp_type", ksp_type, "-pc_type", pc_type, "-ksp_rtol", "1e-6",
                    "-real_dtype", "f32"]
            kj, kp = solve(pt_jax, A, args, b), solve(ptt, A, args, b)
            hj, hp = np.asarray(kj.getConvergenceHistory()), kp.getConvergenceHistory()
            m = min(len(hj), len(hp))
            gap = np.abs(hp[:m].astype(np.float64) - hj[:m].astype(np.float64))
            print(json.dumps({
                "n": n, "ksp": ksp_type, "pc": pc_type,
                "its": [kj.getIterationNumber(), kp.getIterationNumber()],
                "reason": [kj.getConvergedReason().name, kp.getConvergedReason().name],
                "history_dtype": [str(hj.dtype), str(hp.dtype)],
                "max_gap_over_initial_norm": float(gap.max() / float(hj[0])),
                "max_gap_relative": float((gap / hj[:m].astype(np.float64)).max())}))


if __name__ == "__main__":
    main()
