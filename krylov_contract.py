#!/usr/bin/env python3
"""The reference's contract for chip_smoke.py's phase krylov: the JAX
package (petsc_tpu) on the CPU, float64, with the options chip_smoke.py
passes on the card.

    python krylov_contract.py NZ NY NX csr|grid|mixed|passes [TYPE ...]
    python krylov_contract.py N box [TYPE ...]

Modes:

* csr: BASELINE config 2's stencil7 (examples/bench_spmv.py, jittered,
  not symmetric) on NZ x NY x NX as MatAIJ.from_scipy, ILU(0) with
  -pc_factor_transpose_solve, rtol 1e-8, max_it 400, b = A cos(0.01 i),
  x0 = 0, for each of chip_smoke.KRYLOV_CSR_TYPES (or the TYPEs given), with
  chip_smoke.KRYLOV_CSR_EXTRA's options for its type;
* grid: the same operator after setStencilGrid((NZ, NY, NX)), each type of
  chip_smoke.KRYLOV_GRID_PCS with its PC;
* mixed: the same assembled operator under -ksp_mixed_precision with no
  type set (iterative refinement around GMRES(30) + ILU(0));
* passes: the mixed case's refinement pass by pass, in the JAX package and
  in the port on the CPU (:func:`mixed_passes`): each pass's inner its,
  inner history and outer norm, how far the two first corrections and the
  two second right-hand sides lie apart, and each package's inner solve on
  the other's second right-hand side;
* box: the 27-point box (26 / -1) on an N^3 grid as the stencil operator
  (build_dnd + as_mat), jacobi, rtol 1e-8, b = 1, for each type of
  chip_smoke.KRYLOV_BOX_MAX_IT with its max_it (stcg with
  setRadius(KRYLOV_STCG_RADIUS)).

Prints one JSON line per solve: the case, its, reason, the residual
history, the final residual norm, the true relative residual, max |x -
cos(0.01 i)| (config 2), seconds and peak memory (passes: one line of its
own). Not a test, and not part of the port: it imports jax.
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
from petsc_tpu_torch.ops.stencil_build import stencil7_coo  # noqa: E402


def solve(A, b_np, args, ksp_type=None, radius=None):
    pt.init(args=list(args))
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    if ksp_type is not None:
        ksp.setType(ksp_type)
    ksp.setFromOptions()
    if radius is not None:
        ksp.setRadius(radius)
    x = A.createVecRight()
    t0 = time.perf_counter()
    ksp.solve(pt.Vec.from_array(b_np), x)
    xh = np.asarray(x.getArray())[: len(b_np)]
    return ksp, xh, time.perf_counter() - t0


def record(case, ksp, xh, seconds, A_sp, b_np, xs=None):
    out = {"case": case, "ksp_type": ksp.getType(), "pc_type": ksp.getPC().getType(),
           "its": int(ksp.getIterationNumber()), "reason": ksp.getConvergedReason().name,
           "history": [float(h) for h in ksp.getConvergenceHistory()],
           "rnorm": float(ksp.getResidualNorm()),
           "true_relres": float(np.linalg.norm(b_np - A_sp @ xh) / np.linalg.norm(b_np)),
           "seconds": seconds,
           "peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
    if xs is not None:
        out["max_err"] = float(np.max(np.abs(xh - xs)))
    print(json.dumps(out), flush=True)


def _ir_parts(pkg, A_sp, coo):
    """The pieces of -ksp_mixed_precision's refinement in package pkg (the
    JAX package, or the port on the CPU): the inner type's loop, the f64
    operator, the f32 operator and PC, and the inner configuration, bound
    as each package's solve binds them."""
    import jax.numpy as jnp
    import torch
    if pkg == "ref":
        from petsc_tpu.ksp import ksp as kmod
        from petsc_tpu.ksp.common import KSPConfig
        from petsc_tpu.ksp.ir import _to_f32 as f32
        from petsc_tpu.ops import operator
        pt.init(args=list(chip_smoke.KRYLOV_MIXED_ARGS))
        A = pt.MatAIJ.from_scipy(A_sp)
        ksp = pt.KSP().create()
    else:
        import petsc_tpu_torch as ptt
        from petsc_tpu_torch.ksp import ksp as kmod
        from petsc_tpu_torch.ksp.common import KSPConfig
        from petsc_tpu_torch.ksp.ir import to_f32 as f32
        from petsc_tpu_torch.ops import operator
        ptt.init(args=list(chip_smoke.KRYLOV_MIXED_ARGS), device="cpu")
        A = ptt.MatAIJ()
        A.setSizes(A_sp.shape[0])
        A.setPreallocationCOO(*coo[:2])
        A.setValuesCOO(coo[2])
        ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.setUp()
    cfg = ksp._static_cfg()
    inner_cfg = KSPConfig(max_it=min(cfg.max_it, 1000), normtype=cfg.normtype,
                          converged_maxits=True, extra=cfg.extra)
    fn = kmod._IMPLS[ksp.getType()]["fn"]
    A64 = operator.bind(A.meta, A.device_data())
    A32 = operator.bind(A.meta, f32(A.device_data()))
    B32 = operator.bind(ksp.pc.meta, f32(ksp.pc.device_data()))

    def inner(rs):
        """One f32 inner solve from zero: (correction, its, history)."""
        if pkg == "ref":
            v = jnp.asarray(rs)
            res = fn(A32, B32, v, jnp.zeros_like(v), jnp.float32(1e-6), jnp.float32(0.0),
                     jnp.float32(1e30), inner_cfg)
        else:
            v = torch.as_tensor(rs)
            res = fn(A32, B32, v, torch.zeros_like(v), 1e-6, 0.0, 1e30, inner_cfg)
        h = np.asarray(res.history, dtype=np.float64)
        return np.asarray(res.x, dtype=np.float32), int(res.its), h[~np.isnan(h)]

    def mult(x):
        if pkg == "ref":
            return np.asarray(A64.mult(jnp.asarray(x)))
        return A64.mult(torch.as_tensor(x)).numpy()

    return inner, mult


def mixed_passes(nz, ny, nx):
    """The mixed case's refinement pass by pass in both packages, with the
    outer loop of both ksp/ir.py's (x += s dx in f64, r = b - A x, stop at
    rtol 1e-8) run here in numpy so that only the inner solves differ."""
    i, j, v = stencil7_coo(nz, ny, nx)
    n = nz * ny * nx
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
    b_np = A_sp @ np.cos(0.01 * np.arange(n))
    ttol = 1e-8 * np.linalg.norm(b_np)
    parts, out = {}, {"case": "passes", "grid": [nz, ny, nx]}
    for pkg in ("ref", "port_cpu"):
        inner, mult = parts[pkg] = _ir_parts(pkg, A_sp, (i, j, v))
        x, r = np.zeros(n), b_np
        rec = {"pass_its": [], "outer": [], "inner_history": [], "rhs": [], "x": []}
        while len(rec["outer"]) < 30:
            scale = np.linalg.norm(r)
            rs = (r / scale).astype(np.float32)
            dx, its, h = inner(rs)
            x = x + scale * dx.astype(np.float64)
            r = b_np - mult(x)
            rec["pass_its"].append(its)
            rec["outer"].append(float(np.linalg.norm(r)))
            rec["inner_history"].append([float(a) for a in h])
            rec["rhs"].append(rs)
            rec["x"].append(x)
            if rec["outer"][-1] <= ttol:
                break
        out[pkg] = rec
    ref, port = out["ref"], out["port_cpu"]
    out["first_correction_rel_diff"] = float(np.linalg.norm(port["x"][0] - ref["x"][0])
                                             / np.linalg.norm(ref["x"][0]))
    if len(ref["rhs"]) > 1 and len(port["rhs"]) > 1:
        r2, p2 = ref["rhs"][1], port["rhs"][1]
        out["second_rhs_rel_diff"] = float(np.linalg.norm(p2 - r2) / np.linalg.norm(r2))
        out["ref_its_on_port_second_rhs"] = parts["ref"][0](p2)[1]
        out["port_its_on_ref_second_rhs"] = parts["port_cpu"][0](r2)[1]
    for rec in (ref, port):
        del rec["rhs"], rec["x"]
    return out


def main():
    if sys.argv[4:5] == ["passes"]:
        print(json.dumps(mixed_passes(*(int(a) for a in sys.argv[1:4]))), flush=True)
        return
    if sys.argv[2] == "box":
        n = int(sys.argv[1])
        types = sys.argv[3:] or chip_smoke.KRYLOV_BOX_MAX_IT
        from petsc_tpu.ops import stencil_build
        i, j, v = chip_smoke.box27_coo(n)
        A_sp = sp.csr_matrix((v, (i, j)), shape=(n ** 3, n ** 3))
        del i, j, v
        b_np = np.ones(n ** 3)
        for t in types:
            pt.init()
            A = stencil_build.as_mat(*stencil_build.build_dnd((n,) * 3, kind="box"))
            radius = chip_smoke.KRYLOV_STCG_RADIUS if t == "stcg" else None
            args = (*chip_smoke.KRYLOV_BOX_ARGS, "-ksp_max_it",
                    str(chip_smoke.KRYLOV_BOX_MAX_IT[t]))
            ksp, xh, s = solve(A, b_np, args, t, radius)
            record(f"box_{t}", ksp, xh, s, A_sp, b_np)
        return
    nz, ny, nx = (int(a) for a in sys.argv[1:4])
    mode = sys.argv[4]
    i, j, v = stencil7_coo(nz, ny, nx)
    n = nz * ny * nx
    A_sp = sp.csr_matrix((v, (i, j)), shape=(n, n))
    xs = np.cos(0.01 * np.arange(n))
    b_np = A_sp @ xs
    if mode == "mixed":
        pt.init()
        ksp, xh, s = solve(pt.MatAIJ.from_scipy(A_sp), b_np, chip_smoke.KRYLOV_MIXED_ARGS)
        record("mixed", ksp, xh, s, A_sp, b_np, xs)
        return
    if mode == "csr":
        pcs = {t: None for t in (sys.argv[5:] or chip_smoke.KRYLOV_CSR_TYPES)}
    elif mode == "grid":
        pcs = {t: chip_smoke.KRYLOV_GRID_PCS[t] for t in (sys.argv[5:] or
                                                         chip_smoke.KRYLOV_GRID_PCS)}
    else:
        raise SystemExit(f"krylov_contract: unknown mode {mode}")
    for t, pc in pcs.items():
        pt.init()
        A = pt.MatAIJ.from_scipy(A_sp)
        if mode == "grid":
            A.setStencilGrid((nz, ny, nx))
            args = ("-ksp_rtol", "1e-8", "-ksp_max_it", "400", "-pc_type", pc)
        else:
            args = (*chip_smoke.KRYLOV_CSR_ARGS, *chip_smoke.KRYLOV_CSR_EXTRA.get(t, ()))
        ksp, xh, s = solve(A, b_np, args, t)
        record(f"{mode}_{t}", ksp, xh, s, A_sp, b_np, xs)


if __name__ == "__main__":
    main()
