#!/usr/bin/env python3
"""The reference's contract for chip_smoke.py's phase dm_more: the JAX
package (petsc_tpu) on the CPU, float64, on the inputs chip_smoke.py
makes (its DM_* constants and input functions).

    python dm_contract.py [--write] [CASE ...]

Cases (chip_smoke.DM_MORE_CASES; the card runs each through
petsc_tpu_torch):
- stokes_64, stokes_512: examples/stokes_stag.py (MAC Stokes on DMStag,
  FGMRES + fieldsplit Schur full/selfp, ILU(0) and Jacobi blocks, rtol
  1e-10, max_it 400) at -n 64 and 512 (787,456 unknowns), with
  -mat_rcm_layout 0: the reference's RCM probe fails on the pressure
  block (ROADMAP section 3). Iterations, reason, history, u_err, max|div
  u|, the solution's record and the CSR's SHA-256;
- swarm_2d, swarm_3d: DMSwarm on a 1025^2 DMDA with
  insertPointsUsingCellDM(ppcell=4) and a 129^3 one with ppcell=2
  (16,777,216 particles each), the particles permuted, fields w and q
  and a nodal field from the case's seed; depositSum(w),
  projectFields([w, q]), interpolateToParticles, then migrate;
- network_kcl: DMNetwork on the 512 x 512 grid graph, one 1-dof
  component a vertex; createMatrix's pattern (nnz, SHA-256 of indptr and
  indices); the unit-conductance Laplacian from incidence()
  (tests/test_network.py), zeroRowsColumns at the first and last vertex
  (1 V at the first), CG + GAMG to rtol 1e-8;
- letkf: letkf_analysis with Gaspari-Cohn localization, n = 16,384, k =
  32, m = 2,048;
- regressor: Regressor OLS and ridge on a 131,072 x 64 design, lasso on
  its first 16,384 rows (the reference's lasso takes ||X||_2 by a full SVD
  whose U is rows x rows: 137 GB at 131,072 rows);
- pf: PF "x*x + 1" on 2^24 normal entries;
- random: Random().getValues(2^24), then setInterval((-1, 3)) and
  getValues(1000);
- io: config 2's matrix (examples/bench_spmv.py's stencil7 at 22 x 239
  x 239) in PETSc binary, and ex45's 129^3 right-hand side as .vti (the
  solution itself is rounding-made, so no two runs write the same file).

Prints one JSON line per case (with its seconds and peak memory);
--write merges them into tests/data/dm_contract.json, which chip_smoke.py
reads. Not a test and not part of the port: it imports jax.

    python dm_contract.py --spread SEEDS [--matrix] CASE ...

reruns a Stokes case once a seed (SEEDS: a count n for seeds 1..n, or a
comma list) with b multiplied by (1 + 1e-15 xi), or with --matrix every
stored entry of A moved by 1e-16 max|A| xi, xi standard normal from the
seed: the reference's own rounding spread (iterations, history, u_err,
max|div u| and the solution's norm), merged into the case's record under
"spread" beside the runs already there. At n = 64 the reference's
histories part by more than 1e-6 from about entry 119 of 357, and an A
perturbation changes its iterations by one; chip_smoke.py holds such
entries to twice this spread. stokes_512 is the long one (about a minute and a half a run on a CPU).
"""

import hashlib
import importlib.util
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import chip_smoke as cs  # noqa: E402
import petsc_tpu as pt  # noqa: E402

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "tests" / "data" / "dm_contract.json"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_stokes(case, out, perturb=None):
    ex = _example("stokes_stag")
    n = cs.DM_STOKES_N[case]
    if perturb is not None:       # --spread: b or A perturbed at rounding level
        orig = ex.assemble

        def assemble(nn):
            st, A, b, offs = orig(nn)
            A, b = perturb(A, b)
            return st, A, b, offs
        ex.assemble = assemble
    t = time.perf_counter()
    st, A, b, offs = ex.assemble(n)
    out["assemble_s"] = time.perf_counter() - t
    out.update(n=n, rows=A.shape[0], nnz=int(A.nnz),
               csr_sha256=cs.sha256(A.indptr.astype(np.int64)) + cs.sha256(
                   A.indices.astype(np.int64)) + cs.sha256(A.data))
    x_out = {}
    orig_solve = pt.KSP.solve

    def solve(self, b_, x_=None):        # keep the solution (main returns errors only)
        r = orig_solve(self, b_, x_)
        x_out["x"] = np.asarray((x_ if x_ is not None else r).getArray())
        return r
    pt.KSP.solve = solve
    try:
        t = time.perf_counter()
        ksp, uerr, div = ex.main(["-n", str(n), "-mat_rcm_layout", "0"])
        out["solve_s"] = time.perf_counter() - t
    finally:
        pt.KSP.solve = orig_solve
    out.update(its=ksp.getIterationNumber(), reason=int(ksp.getConvergedReason()),
               history=[float(h) for h in ksp.getConvergenceHistory()],
               u_err=float(uerr), div=float(div), x=cs.vector_record(x_out["x"][:A.shape[0]]))


def run_swarm(case, out):
    from petsc_tpu.dm import DMDA
    from petsc_tpu.dm.swarm import DMSwarm
    dim, nn, ppc, npart, nnodes = cs.swarm_grid(case)
    perm, w, q, nodal = cs.swarm_inputs(case)
    secs = {}
    t = time.perf_counter()
    da = DMDA.create(dim, (nn,) * dim)
    sw = DMSwarm.create()
    sw.setCellDM(da)
    sw.insertPointsUsingCellDM(ppcell=ppc)
    sw.setPointCoordinates(sw.getField("DMSwarmPIC_coor")[perm])
    sw.registerField("w", 1)
    sw.registerField("q", 1)
    sw.restoreField("w", w)
    sw.restoreField("q", q)
    secs["setup"] = time.perf_counter() - t
    t = time.perf_counter()
    dep = np.asarray(sw.depositSum("w").getArray())
    secs["depositSum"] = time.perf_counter() - t
    t = time.perf_counter()
    proj = [np.asarray(v.getArray()) for v in sw.projectFields(["w", "q"])]
    secs["projectFields"] = time.perf_counter() - t
    t = time.perf_counter()
    interp = np.asarray(sw.interpolateToParticles(pt.Vec.from_array(nodal)))
    secs["interpolateToParticles"] = time.perf_counter() - t
    t = time.perf_counter()
    sw.migrate()
    secs["migrate"] = time.perf_counter() - t
    cells = sw.binToCells()
    out.update(dim=dim, nodes=nnodes, particles=npart, ppcell=ppc, seconds_by_part=secs,
               weight_sum=float(w.sum()), deposit=cs.vector_record(dep),
               project_w=cs.vector_record(proj[0]), project_q=cs.vector_record(proj[1]),
               interpolate=cs.vector_record(interp),
               migrated_w_sha256=cs.sha256(np.asarray(sw.getField("w"))),
               migrated_cells_sha256=cs.sha256(cells.astype(np.int64)))


def run_network(case, out):
    from petsc_tpu.dm.network import DMNetwork
    edges = cs.network_edges()
    nv = cs.DM_NETWORK_SIDE ** 2
    secs = {}
    t = time.perf_counter()
    net = DMNetwork.create()
    net.addSubnetwork("grid", edges)
    net.layoutSetUp()
    key = net.registerComponent("bus")
    for v in range(nv):
        net.addComponent(v, key, 1)
    net.setUp()
    secs["layout"] = time.perf_counter() - t
    t = time.perf_counter()
    S = net.createMatrix().to_scipy()
    secs["createMatrix"] = time.perf_counter() - t
    src, dst = net.incidence()
    G = np.ones(len(src))
    L = sp.csr_matrix((np.concatenate([G, G, -G, -G]),
                       (np.concatenate([src, dst, src, dst]),
                        np.concatenate([src, dst, dst, src]))), shape=(nv, nv))
    pt.init(args=["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"])
    A = pt.MatAIJ.from_scipy(L)
    xv = np.zeros(nv)
    xv[0] = 1.0
    x = pt.Vec.from_array(xv)
    b = pt.Vec.from_array(np.zeros(nv))
    A.zeroRowsColumns([0, nv - 1], diag=1.0, x=x, b=b)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    sol = A.createVecRight()
    t = time.perf_counter()
    ksp.solve(b, sol)
    secs["solve"] = time.perf_counter() - t
    out.update(vertices=nv, edges=len(edges), nnz=int(S.nnz),
               pattern_sha256=cs.sha256(S.indptr.astype(np.int64)) + cs.sha256(
                   S.indices.astype(np.int64)),
               b=cs.vector_record(np.asarray(b.getArray())[:nv]),
               its=ksp.getIterationNumber(), reason=int(ksp.getConvergedReason()),
               history=[float(h) for h in ksp.getConvergenceHistory()],
               x=cs.vector_record(np.asarray(sol.getArray())[:nv]), seconds_by_part=secs)


def run_letkf(case, out):
    from petsc_tpu.ml.letkf import gaspari_cohn, letkf_analysis
    Xf, yo, H, R, dist = cs.letkf_inputs()
    rho = gaspari_cohn(dist)
    Xa = np.asarray(letkf_analysis(Xf, yo, H, R, localization=rho))
    n, k, m, radius = cs.DM_LETKF
    out.update(n=n, k=k, m=m, radius=radius, rho=cs.vector_record(rho),
               Xa=cs.vector_record(Xa), Xa_mean=cs.vector_record(Xa.mean(axis=1)))


def run_regressor(case, out):
    from petsc_tpu.ml.regressor import Regressor
    X, y = cs.regressor_inputs()
    _, _, ridge_w, lasso_w, lasso_rows = cs.DM_REGRESSOR
    for lt, w, m in (("ols", None, len(y)), ("ridge", ridge_w, len(y)),
                     ("lasso", lasso_w, lasso_rows)):
        r = Regressor()
        r.setLinearType(lt)
        if w is not None:
            r.setRegularizerWeight(w)
        t = time.perf_counter()
        r.fit(X[:m], y[:m])
        out[lt] = {"coef": [float(c) for c in np.asarray(r._coef)],
                   "intercept": float(r.getIntercept()), "seconds": time.perf_counter() - t}


def run_pf(case, out):
    from petsc_tpu.sys.pf import PF
    x = cs.pf_input()
    y = np.asarray(PF.create().setType("string", cs.DM_PF[1]).apply(x))
    out.update(expr=cs.DM_PF[1], sha256=cs.sha256(y), y=cs.vector_record(y),
               equals_numpy_bits=bool(np.array_equal(y.view(np.int64),
                                                      (x * x + 1).view(np.int64))))


def run_random(case, out):
    from petsc_tpu.sys.random import Random
    n, interval, n2 = cs.DM_RANDOM
    r = Random()
    v = np.asarray(r.getValues(n))
    r.setInterval(interval)
    v2 = np.asarray(r.getValues(n2))
    out.update(seed=r._seed, sha256=cs.sha256(v), values=cs.vector_record(v),
               interval=list(interval), interval_sha256=cs.sha256(v2),
               interval_values=cs.vector_record(v2))


def run_io(case, out):
    from petsc_tpu.sys.viewer import mat_save
    from petsc_tpu.sys.vtk import write_vtu
    bench = _example("bench_spmv")
    A = bench._suite_matrices(False)[0][1]
    assert A.shape[0] == int(np.prod(cs.DM_IO_CONFIG2))
    M = pt.MatAIJ.from_scipy(A)
    ex45 = _example("ex45")
    n = cs.DM_IO_EX45
    da = pt.DMDA.create(3, (n, n, n), dof=1, stencil_width=1)
    b = da.createGlobalVector()
    ex45.compute_rhs(None, b)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mat_save(f"{tmp}/config2.bin", M)
        out["mat_save_s"] = time.perf_counter() - t
        t = time.perf_counter()
        write_vtu(da, f"{tmp}/ex45_rhs.vti", point_data={"rhs": b})
        out["write_vtu_s"] = time.perf_counter() - t
        for f in ("config2.bin", "ex45_rhs.vti"):
            data = Path(f"{tmp}/{f}").read_bytes()
            out[f] = {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}


RUNS = {"stokes_64": run_stokes, "stokes_512": run_stokes, "swarm_2d": run_swarm,
        "swarm_3d": run_swarm, "network_kcl": run_network, "letkf": run_letkf,
        "regressor": run_regressor, "pf": run_pf, "random": run_random, "io": run_io}


def run(case):
    pt.init(args=[])
    t0 = time.perf_counter()
    out = {"case": case}
    RUNS[case](case, out)
    out["seconds"] = time.perf_counter() - t0
    out["peak_rss_GB"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(json.dumps({k: v for k, v in out.items() if k not in ("history",)}), flush=True)
    return out


def spread(case, seeds, matrix=False):
    """The case's runs, one a seed, with b multiplied by (1 + 1e-15 xi), or
    with --matrix every stored entry of A moved by 1e-16 max|A| xi (xi
    standard normal from the seed): {"perturbation", "seeds", "its",
    "history", "u_err", "div", "x_norm2"}, one list entry a run."""
    keys = ("its", "history", "u_err", "div")
    kind = "A 1e-16 max|A|" if matrix else "b 1e-15"
    runs = {"perturbation": [], "seeds": [], **{k: [] for k in keys + ("x_norm2",)}}
    for seed in seeds:
        rng = np.random.default_rng(seed)

        def perturb(A, b):
            if matrix:
                A = A.copy()
                A.data = A.data + 1e-16 * np.abs(A.data).max() * rng.standard_normal(A.nnz)
                return A, b
            return A, b * (1.0 + 1e-15 * rng.standard_normal(len(b)))
        out = {}
        pt.init(args=[])
        run_stokes(case, out, perturb)
        runs["perturbation"].append(kind)
        runs["seeds"].append(seed)
        for k in keys:
            runs[k].append(out[k])
        runs["x_norm2"].append(out["x"]["norm2"])
        print(json.dumps({"case": case, "perturbation": kind, "seed": seed,
                          **{k: out[k] for k in ("its", "u_err", "div")}}), flush=True)
    return runs


def _merge(case, key, value):
    """Write a case's record (key None) or its spread: the new runs beside
    the recorded ones of other perturbations or seeds."""
    import fcntl
    with open(OUT.with_suffix(".lock"), "w") as lock:   # parallel runs merge in turn
        fcntl.flock(lock, fcntl.LOCK_EX)
        old = json.loads(OUT.read_text()) if OUT.exists() else {}
        if key is None:
            old[case] = value
        else:
            prev = old[case].get(key) or {k: [] for k in value}
            new = set(zip(value["perturbation"], value["seeds"]))
            keep = [i for i, ps in enumerate(zip(prev["perturbation"], prev["seeds"]))
                    if ps not in new]
            old[case][key] = {k: [prev[k][i] for i in keep] + value[k] for k in value}
        OUT.write_text(json.dumps(old, indent=1) + "\n")


def main():
    argv = sys.argv[1:]
    if argv and argv[0] == "--spread":
        arg, rest = argv[1], argv[2:]
        seeds = [int(a) for a in arg.split(",") if a] if "," in arg else range(1, int(arg) + 1)
        for c in [a for a in rest if a != "--matrix"]:
            _merge(c, "spread", spread(c, seeds, matrix="--matrix" in rest))
        return
    write = "--write" in argv
    cases = [a for a in argv if a != "--write"] or list(cs.DM_MORE_CASES)
    for c in cases:
        got = run(c)
        if write:       # merged case by case, so a long run keeps what it made
            _merge(c, None, got)


if __name__ == "__main__":
    main()
