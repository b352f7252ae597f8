#!/usr/bin/env python3
"""The reference's contract for chip_smoke.py's phase nonlinear: the JAX
package (petsc_tpu) on the CPU, float64, with the settings chip_smoke.py
uses on the card.

    python snes_contract.py [--write] [CASE ...]

Cases (CASES below; the card runs each through petsc_tpu_torch):
- ex5_257, ex5_1025: PETSc's ex5 (Bratu, lambda 6) on an n x n DMDA,
  Newton LS with CG + GAMG inner solves (KSP rtol 1e-5, max_it 200) and
  ex5.c's initial guess (examples/snes_ts_probe.py's bratu_block);
- ex19_r3, ex19_r6: PETSc's ex19 (examples/ex19.py) at -da_refine 3 and 6,
  JFNK with the FD-colouring preconditioning matrix;
- heat_cn_129, heat_cn_1025: Crank-Nicolson heat steps with the compiled
  JFNK stage solve, dt = hx^2, 50 steps (snes_ts_probe.py's ts_heat_block);
- heat_rk_adjoint: rk 3bs, dt = 0.2 hx^2, 20 fixed steps at 257^2 with a
  saved trajectory, then adjointSolve(dJdu = u_T);
- tao_lmvm, tao_nls: the chained Rosenbrock of tests/test_tao.py at
  n = 2^20 from x0 = 0.

Prints one JSON line per case (its, reason, histories, norms and 16
sampled entries of the result at the indices of sample_indices, the
case's parameters, seconds and peak memory); --write merges them into
tests/data/snes_contract.json, which chip_smoke.py reads. Not a test, and
not part of the port: it imports jax. ex5_1025 takes minutes and several
GB.
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

import petsc_tpu as pt  # noqa: E402

OUT = Path(__file__).resolve().parent / "tests" / "data" / "snes_contract.json"

CASES = {
    "ex5_257": {"kind": "ex5", "n": 257, "par": 6.0, "ksp_rtol": 1e-5, "ksp_max_it": 200},
    "ex5_1025": {"kind": "ex5", "n": 1025, "par": 6.0, "ksp_rtol": 1e-5, "ksp_max_it": 200},
    "ex19_r3": {"kind": "ex19", "refine": 3},
    "ex19_r6": {"kind": "ex19", "refine": 6},
    "heat_cn_129": {"kind": "heat_cn", "n": 129, "steps": 50},
    "heat_cn_1025": {"kind": "heat_cn", "n": 1025, "steps": 50},
    "heat_rk_adjoint": {"kind": "heat_rk_adjoint", "n": 257, "steps": 20, "dt_factor": 0.2,
                        "rk_type": "3bs"},
    "tao_lmvm": {"kind": "tao", "type": "lmvm", "log2n": 20},
    "tao_nls": {"kind": "tao", "type": "nls", "log2n": 20},
}


def sample_indices(n, k=16, seed=23):
    """k sorted distinct indices of 0..n-1, from a seeded generator."""
    return np.sort(np.random.default_rng(seed).choice(n, size=k, replace=False))


def ex5_guess(nx, ny, lam):
    """ex5.c's FormInitialGuess on an nx x ny grid, x fastest."""
    yi, xi = np.divmod(np.arange(nx * ny), nx)
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    g = lam / (lam + 1.0) * np.sqrt(np.minimum(np.minimum(xi, nx - 1 - xi) * hx,
                                               np.minimum(yi, ny - 1 - yi) * hy))
    g[(xi == 0) | (xi == nx - 1) | (yi == 0) | (yi == ny - 1)] = 0.0
    return g


def heat_u0(n):
    """sin(pi x) sin(pi y) on the n x n unit grid, x fastest."""
    yi, xi = np.divmod(np.arange(n * n), n)
    h = 1.0 / (n - 1)
    return np.sin(np.pi * xi * h) * np.sin(np.pi * yi * h)


def rosenbrock(x):
    return jnp.sum(100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2)


def vector_record(v):
    v = np.asarray(v, dtype=np.float64)
    idx = sample_indices(len(v))
    return {"norm2": float(np.linalg.norm(v)), "sample_idx": idx.tolist(),
            "sample": [float(a) for a in v[idx]]}


def run(case):
    p = dict(CASES[case])
    kind = p["kind"]
    t0 = time.perf_counter()
    out = {"case": case, **p}
    if kind == "ex5":
        from examples.ex5 import make_jacobian, make_residual
        pt.init(args=[])
        n, lam = p["n"], p["par"]
        da = pt.DMDA.create(2, (n, n), dof=1, stencil_width=1)
        snes = pt.SNES().create()
        snes.setDM(da)
        snes.setFunction(make_residual(da, lam))
        snes.setJacobian(make_jacobian(da, lam), J=da.createMatrix())
        ksp = snes.getKSP()
        ksp.setType("cg")
        ksp.getPC().setType("gamg")
        ksp.setTolerances(rtol=p["ksp_rtol"], max_it=p["ksp_max_it"])
        inner = []
        snes.setMonitor(lambda s, it, fn: inner.append(int(ksp.getIterationNumber())))
        x = da.createGlobalVector()
        x.setArray(ex5_guess(n, n, lam))
        snes.solve(None, x)
        levels = [int(lev.A.getSize()[0]) for lev in ksp.getPC()._impl.levels]
        out.update(its=snes.getIterationNumber(), reason=int(snes.getConvergedReason()),
                   history=[float(h) for h in snes.getConvergenceHistory()],
                   ksp_its=inner[1:], gamg_levels=levels,
                   x=vector_record(x.getArray()))
    elif kind == "ex19":
        import examples.ex19 as ex19
        snes, x, (mx, my) = ex19.main(["-da_refine", str(p["refine"]), "-snes_monitor_short"])
        out.update(mx=mx, my=my, its=snes.getIterationNumber(),
                   reason=int(snes.getConvergedReason()),
                   history=[float(h) for h in snes.getConvergenceHistory()],
                   x=vector_record(np.asarray(x.getArray())[: mx * my * 4]))
    elif kind == "heat_cn":
        from examples.heat import make_rhs
        pt.init(args=[])
        n = p["n"]
        da = pt.DMDA.create(2, (n, n), dof=1, stencil_width=1)
        hx = 1.0 / (n - 1)
        dt = hx * hx
        ts = pt.TS().create()
        ts.setType("cn")
        ts.setRHSFunction(make_rhs(da))
        ts.use_compiled_snes = True
        ts.setTimeStep(dt)
        ts.setMaxSteps(p["steps"])
        ts.setMaxTime(1e9)
        u0 = heat_u0(n)
        u = pt.Vec.from_array(jnp.asarray(u0))
        ts.solve(u)
        uT = np.asarray(u.getArray())
        tend = float(ts.getTime())
        err = float(np.abs(uT - u0 * np.exp(-2 * np.pi ** 2 * tend)).max())
        out.update(dt=dt, steps_taken=ts.getStepNumber(), t_end=tend,
                   max_err_vs_analytic=err, u=vector_record(uT))
    elif kind == "heat_rk_adjoint":
        from examples.heat import make_rhs
        pt.init(args=[])
        n = p["n"]
        da = pt.DMDA.create(2, (n, n), dof=1, stencil_width=1)
        hx = 1.0 / (n - 1)
        dt = p["dt_factor"] * hx * hx
        ts = pt.TS().create()
        ts.setType("rk")
        ts.setRKType(p["rk_type"])
        ts.setRHSFunction(make_rhs(da))
        ts.adapt.kind = "none"
        ts.setTimeStep(dt)
        ts.setMaxSteps(p["steps"])
        ts.setMaxTime(1e9)
        ts.setSaveTrajectory()
        u0 = heat_u0(n)
        u = pt.Vec.from_array(jnp.asarray(u0))
        ts.solve(u)
        uT = np.asarray(u.getArray())
        lam0 = np.asarray(ts.adjointSolve(uT, u0).getArray())
        out.update(dt=dt, steps_taken=ts.getStepNumber(), t_end=float(ts.getTime()),
                   u=vector_record(uT), lambda0=vector_record(lam0))
    elif kind == "tao":
        pt.init(args=[])
        n = 2 ** p["log2n"]
        tao = pt.Tao().create()
        tao.setType(p["type"])
        tao.setObjective(rosenbrock)
        x = pt.Vec.from_array(np.zeros(n))
        tao.solve(x)
        out.update(its=tao.getIterationNumber(), reason=int(tao.getConvergedReason()),
                   f_history=[float(f) for f, _ in tao._history],
                   g_history=[float(g) for _, g in tao._history],
                   f=float(tao.getObjectiveValue()), gnorm=float(tao.getGradientNorm()),
                   x=vector_record(x.getArray()))
    else:
        raise KeyError(kind)
    out["seconds"] = time.perf_counter() - t0
    out["peak_rss_GB"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(json.dumps(out), flush=True)
    return out


def main():
    argv = sys.argv[1:]
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
