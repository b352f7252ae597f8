#!/usr/bin/env python3
"""The reference's contract for chip_smoke.py's phase plex: the JAX
package (petsc_tpu) on the CPU, float64, with the settings chip_smoke.py
uses on the card.

    python plex_contract.py [--write] [CASE ...]

Cases (CASES below; the card runs each through petsc_tpu_torch):
- ex12_p2_256, ex12_p2_64: PETSc's SNES ex12 (examples/ex12.py), P2 on a
  faces x faces simplex box, -div((1 + u^2) grad u) = f, SNES rtol 1e-10;
  256 with GMRES + GAMG inner solves, 64 at PETSc's defaults (GMRES(30) +
  ILU(0)). ex12_p2_512 (1,050,625 dofs) is the same case at 512^2; the
  JAX package's GMRES + GAMG iterations on this CPU take over an hour
  there, so the card holds the 256^2 one. examples/ex12.py's body is repeated here, all but its nodal
  error, which it takes with one JAX call per dof (a million at 512): this
  script evaluates u_exact = sin(pi x) sin(pi y) on the dof coordinates in
  one numpy expression instead;
- plex_mg_1025: assemblePoissonP1 on createBoxMesh((64, 64)) refined 4
  times (1025^2 vertices), CG + PCMG from the plex hierarchy with
  -pc_mg_levels 5, rtol 1e-8 (tests/test_plex_refine.py's geometric MG at
  full size);
- fvplex_advect_724: FVPlex upwind, order 2, Barth-Jespersen, on
  createBoxMesh((724, 724)) (1,048,352 cells): the bump of
  tests/test_fv_plex.py's _advect, SSP-RK2, cfl 0.4, T = 0.05.

Prints one JSON line per case (iterations, reasons, histories, norms and
16 sampled entries of the result at the indices of sample_indices, the
case's parameters, seconds by part and peak memory); --write merges them
into tests/data/plex_contract.json, which chip_smoke.py reads. Not a
test, and not part of the port: it imports jax. ex12_p2_256 takes about
an hour and 4 GB (ex12_p2_512 did not finish in 80 minutes, 11 GB).

    python plex_contract.py --spread SEEDS [--jacobian] CASE ...

reruns each ex12 case once a seed (SEEDS: a count n for seeds 1..n, or a
comma list) with every residual the DS assembles
multiplied by (1 + 1e-15 xi), or with --jacobian every stored entry of
each Jacobian the DS assembles moved by 1e-16 max|J| xi, xi standard normal
from a seeded generator: the reference's own rounding spread. It merges
the runs' inner its and histories into the case's record under "spread"
(ex12_p2_64's GMRES(30) + ILU(0) solves of 150 to 250 iterations part in
their last two Newton steps; ex12_p2_256's GAMG drops the entries of its
Galerkin products that cancel to zero, so a rounding-level change of J
changes its coarse patterns; chip_smoke.py holds such entries to twice
this spread).
"""

import json
import resource
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import petsc_tpu as pt  # noqa: E402

OUT = Path(__file__).resolve().parent / "tests" / "data" / "plex_contract.json"

CASES = {
    "ex12_p2_512": {"kind": "ex12", "order": 2, "faces": 512,
                    "args": ["-ksp_type", "gmres", "-pc_type", "gamg"]},
    "ex12_p2_256": {"kind": "ex12", "order": 2, "faces": 256,
                    "args": ["-ksp_type", "gmres", "-pc_type", "gamg"]},
    "ex12_p2_64": {"kind": "ex12", "order": 2, "faces": 64, "args": []},
    "plex_mg_1025": {"kind": "plex_mg", "faces": 64, "refine": 4, "levels": 5,
                     "rtol": 1e-8, "max_it": 50},
    "fvplex_advect_724": {"kind": "fvplex", "faces": 724, "T": 0.05, "cfl": 0.4,
                          "vel": [1.0, 0.5], "order": 2, "limiter": "barth"},
}


def sample_indices(n, k=16, seed=24):
    """k sorted distinct indices of 0..n-1, from a seeded generator."""
    return np.sort(np.random.default_rng(seed).choice(n, size=k, replace=False))


def vector_record(v):
    v = np.asarray(v, dtype=np.float64)
    idx = sample_indices(len(v))
    return {"norm2": float(np.linalg.norm(v)), "min": float(v.min()), "max": float(v.max()),
            "sample_idx": idx.tolist(), "sample": [float(a) for a in v[idx]]}


def fv_bump(x, y):
    """tests/test_fv_plex.py's _advect initial state."""
    return np.exp(-((x - 0.3) ** 2 + (y - 0.3) ** 2) / 0.02)


def fv_steps(vol_min, cfl, vel, T):
    """(steps, dt) of tests/test_fv_plex.py's _advect."""
    h = float(np.sqrt(vol_min))
    dt = cfl * h / np.hypot(*vel)
    nst = int(np.ceil(T / dt))
    return nst, T / nst


def run_ex12(p, out):
    from examples.ex12 import forcing, u_exact  # noqa: F401  (forcing: the weak form below)
    from petsc_tpu.dm.fe import DS, lagrange_fe
    from petsc_tpu.dm.plex import DMPlex
    order, faces = p["order"], p["faces"]
    pt.init(args=["-fe_order", str(order), "-faces", str(faces), *p["args"]])
    secs = {}
    t = time.perf_counter()
    plex = DMPlex.createBoxMesh((faces, faces), simplex=True)
    secs["mesh"] = time.perf_counter() - t
    t = time.perf_counter()
    ds = DS(plex, lagrange_fe(2, order))
    secs["dof_layout"] = time.perf_counter() - t
    ds.setResidual(f0=lambda u, gu, x: -forcing(x),
                   f1=lambda u, gu, x: (1.0 + u * u) * gu)
    bnd = ds.boundary_dofs(lambda x: x.min() < 1e-9 or x.max() > 1 - 1e-9)
    n = ds.ndof
    secs["residual"] = secs["jacobian"] = 0.0

    def residual(snes, x, f):
        t0 = time.perf_counter()
        u = np.asarray(x.getArray())[:n]
        F = np.array(ds.assembleResidual(u))
        F[bnd] = u[bnd]
        f.setArray(np.pad(F, (0, len(np.asarray(x.getArray())) - n)))
        secs["residual"] += time.perf_counter() - t0

    def jacobian(snes, x, J, P):
        t0 = time.perf_counter()
        u = np.asarray(x.getArray())[:n]
        A = ds.assembleJacobian(u).tolil()
        for r in bnd:
            A.rows[r] = [int(r)]
            A.data[r] = [1.0]
        A = A.tocsr()
        coo = A.tocoo()
        keep = ~np.isin(coo.col, bnd) | (coo.row == coo.col)
        A = sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape)
        P.setValuesCSR(A.indptr, A.indices, A.data)
        P.assemble()
        secs["jacobian"] += time.perf_counter() - t0

    snes = pt.SNES().create()
    J = pt.MatAIJ(None)
    J.setSizes((n, n))
    x = pt.Vec.from_array(np.zeros(n))
    f = pt.Vec.from_array(np.zeros(n))
    snes.setFunction(residual, f)
    snes.setJacobian(jacobian, J, J)
    snes.setTolerances(rtol=1e-10, atol=1e-12)
    snes.setFromOptions()
    ksp = snes.getKSP()
    inner = []
    snes.setMonitor(lambda s, it, fn: inner.append(int(ksp.getIterationNumber())))
    t = time.perf_counter()
    snes.solve(None, x)
    secs["solve"] = time.perf_counter() - t
    u = np.asarray(x.getArray())[:n]
    xy = ds.dof_coords
    uex = np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1])
    out.update(ndof=n, ncells=plex.ncells, nbnd=len(bnd), its=snes.getIterationNumber(),
               reason=int(snes.getConvergedReason()),
               history=[float(h) for h in snes.getConvergenceHistory()],
               ksp_its=inner[1:], ksp_type=ksp.getType(), pc_type=ksp.getPC().getType(),
               max_err=float(np.abs(u - uex).max()), u=vector_record(u), host_seconds=secs)


def run_plex_mg(p, out):
    from petsc_tpu.dm.plex import DMPlex
    secs = {}
    t = time.perf_counter()
    plex = DMPlex.createBoxMesh((p["faces"], p["faces"]), simplex=True)
    secs["mesh"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(p["refine"]):
        plex = plex.refine()
    secs["refine"] = time.perf_counter() - t
    t = time.perf_counter()
    A, b = plex.assemblePoissonP1(f=1.0)
    secs["assemble"] = time.perf_counter() - t
    pt.init(args=["-pc_mg_levels", str(p["levels"])])
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setType("cg")
    ksp.getPC().setType("mg")
    ksp.getPC().setFromOptions()
    ksp.setTolerances(rtol=p["rtol"], max_it=p["max_it"])
    x = A.createVecRight()
    t = time.perf_counter()
    ksp.solve(b, x)
    secs["solve"] = time.perf_counter() - t
    A_sp = A.to_scipy()
    n = A_sp.shape[0]
    xv = np.asarray(x.getArray())[:n]
    bv = np.asarray(b.getArray())[:n]
    relres = float(np.linalg.norm(A_sp @ xv - bv) / np.linalg.norm(bv))
    levels = [int(lev.A.getSize()[0]) for lev in ksp.getPC()._impl.levels]
    out.update(n=n, nnz=int(A_sp.nnz), its=ksp.getIterationNumber(),
               reason=int(ksp.getConvergedReason()),
               history=[float(h) for h in ksp.getConvergenceHistory()],
               true_relres=relres, mg_levels=levels, x=vector_record(xv), host_seconds=secs)


def run_fvplex(p, out):
    from petsc_tpu.dm.fv_plex import FVPlex
    from petsc_tpu.dm.plex import DMPlex
    secs = {}
    t = time.perf_counter()
    mesh = DMPlex.createBoxMesh((p["faces"], p["faces"]), simplex=True)
    secs["mesh"] = time.perf_counter() - t
    vx, vy = p["vel"]

    def flux(u):
        return (vx * u, vy * u)

    def wavespeed(uL, uR, n):
        return vx * n[:, 0] + vy * n[:, 1]

    t = time.perf_counter()
    fv = FVPlex(mesh, flux, wavespeed, riemann="upwind", bc="outflow", order=p["order"],
                limiter=p["limiter"])
    secs["face_geometry_and_ls"] = time.perf_counter() - t
    rhs = fv.makeRHS()
    g = fv.geom
    cc = g["ccent"]
    u = jnp.asarray(fv_bump(cc[:, 0], cc[:, 1]))
    nst, dt = fv_steps(g["vol"].min(), p["cfl"], p["vel"], p["T"])

    @jax.jit
    def step(u):
        k1 = rhs(0.0, u)
        u1 = u + dt * k1
        return 0.5 * (u + u1 + dt * rhs(0.0, u1))

    t = time.perf_counter()
    for _ in range(nst):
        u = step(u)
    u = np.asarray(u)
    secs["steps"] = time.perf_counter() - t
    out.update(ncells=mesh.ncells, nfaces=len(g["cL"]), steps=nst, dt=dt, u=vector_record(u),
               host_seconds=secs)


def run(case):
    p = dict(CASES[case])
    t0 = time.perf_counter()
    out = {"case": case, **p}
    {"ex12": run_ex12, "plex_mg": run_plex_mg, "fvplex": run_fvplex}[p["kind"]](p, out)
    out["seconds"] = time.perf_counter() - t0
    out["peak_rss_GB"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(json.dumps(out), flush=True)
    return out


def spread(case, seeds, jacobian=False):
    """The case's runs (one a seed of `seeds`) with its residual perturbed by 1e-15 relative, or
    its Jacobian by 1e-16 of its largest entry (see the module's
    docstring): {"perturbation", "seeds", "ksp_its", "history", "max_err"}."""
    import petsc_tpu.dm.fe as fe
    name = "assembleJacobian" if jacobian else "assembleResidual"
    orig = getattr(fe.DS, name)
    runs = {"perturbation": "jacobian 1e-16 max|J|" if jacobian else "residual 1e-15",
            "seeds": [], "ksp_its": [], "history": [], "max_err": []}
    try:
        for seed in seeds:
            rng = np.random.default_rng(seed)

            def perturbed(self, u, _rng=rng):
                if jacobian:
                    A = orig(self, u).tocsr()
                    A.data = A.data + 1e-16 * np.abs(A.data).max() \
                        * _rng.standard_normal(A.data.shape)
                    return A
                F = np.asarray(orig(self, u))
                return F * (1.0 + 1e-15 * _rng.standard_normal(F.shape))

            setattr(fe.DS, name, perturbed)
            out = {}
            run_ex12(dict(CASES[case]), out)
            for k in ("ksp_its", "history", "max_err"):
                runs[k].append(out[k])
            runs["seeds"].append(seed)
            print(json.dumps({"case": case, "seed": seed, **{k: out[k] for k in (
                "its", "ksp_its", "history", "max_err")}}), flush=True)
    finally:
        setattr(fe.DS, name, orig)
    return runs


def main():
    argv = sys.argv[1:]
    if argv and argv[0] == "--spread":
        # SEEDS: a count n (seeds 1..n) or a comma list; runs of the same
        # perturbation already in the record are kept beside the new ones
        arg, rest = argv[1], argv[2:]
        seeds = [int(a) for a in arg.split(",") if a] if "," in arg else range(1, int(arg) + 1)
        jacobian = "--jacobian" in rest
        cases = [a for a in rest if a != "--jacobian"]
        import fcntl
        for c in cases:
            runs = spread(c, seeds, jacobian)
            with open(OUT.with_suffix(".lock"), "w") as lock:   # runs in parallel merge in turn
                fcntl.flock(lock, fcntl.LOCK_EX)
                old = json.loads(OUT.read_text())
                prev = old[c].get("spread")
                if prev and prev.get("perturbation") == runs["perturbation"]:
                    new = [i for i, s_ in enumerate(runs["seeds"]) if s_ not in prev["seeds"]]
                    for k in ("seeds", "ksp_its", "history", "max_err"):
                        runs[k] = prev[k] + [runs[k][i] for i in new]
                old[c]["spread"] = runs
                OUT.write_text(json.dumps(old, indent=1) + "\n")
        return
    write = "--write" in argv
    cases = [a for a in argv if a != "--write"] or list(CASES)
    for c in cases:
        got = run(c)
        if write:       # merged case by case, so a long run keeps what it made
            old = json.loads(OUT.read_text()) if OUT.exists() else {}
            old[c] = got
            OUT.write_text(json.dumps(old, indent=1) + "\n")


if __name__ == "__main__":
    main()
