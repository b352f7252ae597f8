"""The port's SNES against the JAX package's, case for case with
tests/test_snes.py (newtonls, newtontr, qn, anderson, nrichardson, the
Jacobian modes, PETSc's ex5 Bratu, FD colouring, Eisenstat-Walker, the
device-loop JFNK, the line searches), plus the registry types that file
leaves out (ksponly, ksptransposeonly, ngmres, the basic line search) and
the jvp of the ported ex5 residual against a finite difference.

Tolerances (tests/nonlinear_parity.py): iterations and reasons equal,
histories to 1e-6 relative (entries below 1e-6 of the first to 1e-12 of
the first), final iterates to 1e-10 relative."""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tests.nonlinear_parity import (JAX, TORCH, assert_snes_same, assert_vec, both, host,
                                    init, snes_record)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from examples import ex5 as ex5_jax  # noqa: E402
from petsc_tpu_torch.examples import ex5 as ex5_port  # noqa: E402

torch.set_num_threads(1)

EX5 = {"jax": ex5_jax, "torch": ex5_port}


@pytest.fixture(autouse=True)
def _cpu():
    init()


def small_system(B):
    """x^2 + x y = 3, x y + y^2 = 6; solution (1, 2)."""
    def F(x):
        return B.xp.stack([x[0] ** 2 + x[0] * x[1] - 3.0,
                           x[0] * x[1] + x[1] ** 2 - 6.0])
    return F


def tridiag(n):
    return sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr")


def run_small(B, snes_type="newtonls", jac=None):
    snes = B.pt.SNES().create()
    snes.setType(snes_type)
    snes.setFunction(small_system(B))
    if jac == "fd":
        snes.setUseFD(True, coloring=False)
    elif jac == "mf":
        snes.setUseMF(True)
    x = B.pt.Vec.from_array(np.array([2.0, 3.0]))
    snes.solve(None, x)
    return snes_record(snes, x)


@pytest.mark.parametrize("stype", ["newtonls", "newtontr"])
def test_small_system(stype):
    port, ref = both(run_small, stype)
    assert port["reason"] > 0
    assert np.allclose(port["x"], [1.0, 2.0], atol=1e-5)
    assert_snes_same(port, ref)


@pytest.mark.parametrize("jac", ["fd", "mf"])
def test_small_system_jacobian_modes(jac):
    port, ref = both(run_small, "newtonls", jac)
    assert port["reason"] > 0
    assert_snes_same(port, ref)


@pytest.mark.parametrize("stype", ["ksponly", "ksptransposeonly"])
def test_ksponly(stype):
    """One Newton step and CONVERGED_ITS (impls/ksponly)."""
    port, ref = both(run_small, stype)
    assert port["its"] == 1 and port["reason"] == 5
    assert_snes_same(port, ref)


def run_gradient(B, stype, n=24):
    Tm = B.arr(tridiag(n).toarray())

    def F(x):
        return Tm @ x + 0.5 * B.xp.tanh(x) - 1.0

    snes = B.pt.SNES().create()
    snes.setType(stype)
    snes.setTolerances(rtol=1e-10, max_it=500)
    snes.setFunction(F)
    x = B.pt.Vec.from_array(np.zeros(n))
    snes.solve(None, x)
    return snes_record(snes, x)


@pytest.mark.parametrize("stype", ["qn", "anderson", "ngmres"])
def test_gradient_system(stype):
    """A monotone (gradient-type) residual, qn's and anderson's use."""
    port, ref = both(run_gradient, stype)
    assert port["reason"] > 0
    assert_snes_same(port, ref)


def run_nrichardson(B):
    snes = B.pt.SNES().create()
    snes.setType("nrichardson")
    snes.setTolerances(rtol=1e-10, max_it=200)
    snes.setFunction(lambda x: x - B.xp.cos(x))
    x = B.pt.Vec.from_array(np.zeros(6))
    snes.solve(None, x)
    return snes_record(snes, x)


def test_nrichardson():
    port, ref = both(run_nrichardson)
    assert np.allclose(port["x"], 0.7390851332151607, atol=1e-6)
    assert_snes_same(port, ref)


def run_ex5(B, argv):
    snes, x = EX5[B.name].main(argv, **({"device": "cpu"} if B is TORCH else {}))
    return snes_record(snes, x)


@pytest.mark.parametrize("argv", [
    ["-da_grid_x", "17", "-da_grid_y", "17", "-par", "6.0"],
    ["-da_grid_x", "17", "-da_grid_y", "17", "-snes_ksp_ew"],
], ids=["bratu", "ew_forcing"])
def test_bratu_ex5(argv):
    port, ref = both(run_ex5, argv)
    assert port["reason"] > 0 and port["its"] <= 6
    assert_snes_same(port, ref)


def run_ex5_jvp_gmres(B):
    B.pt.init(args=["-snes_mf"], **({"device": "cpu"} if B is TORCH else {}))
    da = B.pt.DMDA.create(2, (17, 17))
    snes = B.pt.SNES().create()
    snes.setFunction(EX5[B.name].make_residual(da, 6.0))
    snes.getKSP().setType("gmres")
    x = da.createGlobalVector()
    snes.setFromOptions()
    snes.solve(None, x)
    return snes_record(snes, x)


def test_bratu_ex5_jvp_gmres():
    """A matrix-free JVP Jacobian and the dense jacfwd pmat (-snes_mf)."""
    port, ref = both(run_ex5_jvp_gmres)
    assert port["reason"] > 0
    assert_snes_same(port, ref)


def run_fd_coloring(B, n=30, sparse_product=False):
    Tm = B.arr(tridiag(n).toarray())

    def F(x):
        if sparse_product:      # the reference test's own form
            return B.arr(tridiag(n) @ np.asarray(x)) + 0.1 * x ** 3 - 1.0
        return Tm @ x + 0.1 * x ** 3 - 1.0

    snes = B.pt.SNES().create()
    snes.setFunction(F)
    snes.setJacobian(J=None, P=B.pt.MatAIJ.from_scipy(tridiag(n)))
    snes._jac_mode = "fd_color"
    x = B.pt.Vec.from_array(np.zeros(n))
    snes.solve(None, x)
    return snes_record(snes, x)


def test_fd_coloring():
    """Known difference (ROADMAP section 3): the FD Jacobian divides
    rounding-level differences of F by h ~ 1.5e-8, and the reference's
    history moves by 2.5e-6 relative when its residual's product is
    sparse rather than dense. The port's history is held to 1e-6 or to
    twice that spread of the reference's own, whichever is larger;
    iterations, reason and the final iterate as everywhere."""
    port, ref = both(run_fd_coloring)
    ref2 = run_fd_coloring(JAX, sparse_product=True)
    assert port["reason"] > 0
    assert (port["its"], port["reason"]) == (ref["its"], ref["reason"])
    spread = np.abs(ref["history"] - ref2["history"])
    gap = np.abs(port["history"] - ref["history"])
    assert np.all(gap <= np.maximum(1e-6 * ref["history"], 2 * spread)), (gap, spread)
    assert_vec(port["x"], ref["x"])


def run_dm_fd_coloring(B):
    da = B.pt.DMDA.create(2, (17, 17), stencil_type="star")
    snes = B.pt.SNES().create()
    snes.setDM(da)
    snes.setFunction(EX5[B.name].make_residual(da, 6.0))
    snes.setUseFD(True, coloring=True)
    x = da.createGlobalVector()
    snes.solve(None, x)
    out = snes_record(snes, x)
    out["ncolors"] = int(np.max(snes._fd_coloring["ncolors"] if B is TORCH
                                else snes._fd_coloring[1].max() + 1))
    return out


def test_bratu_dm_fd_coloring():
    """No user Jacobian: the DMDA's stencil pattern drives the coloured FD
    Jacobian (snesj2.c + fdda.c); both packages colour alike."""
    port, ref = both(run_dm_fd_coloring)
    assert port["reason"] > 0 and port["its"] <= 8
    assert port["ncolors"] == ref["ncolors"]
    assert_snes_same(port, ref)


def run_compiled(B, problem):
    snes = B.pt.SNES().create()
    if problem == "small":
        snes.setFunction(small_system(B))
        snes.setTolerances(rtol=1e-10)
        x = B.pt.Vec.from_array(np.array([2.0, 3.0]))
    else:
        da = B.pt.DMDA.create(2, (17, 17))
        snes.setFunction(EX5[B.name].make_residual(da, 6.0))
        snes.setTolerances(rtol=1e-8)
        x = da.createGlobalVector()
    snes.solveCompiled(x)
    return {"its": snes.getIterationNumber(), "reason": int(snes.getConvergedReason()),
            "fnorm": snes.getFunctionNorm(), "x": host(x)}


@pytest.mark.parametrize("problem", ["small", "bratu"])
def test_solve_compiled_jfnk(problem):
    """The device-loop JFNK gives the reference's iterate (it stops the
    backtracking at the first accepted lambda; the reference evaluates all
    seven)."""
    port, ref = both(run_compiled, problem)
    assert port["reason"] > 0
    assert port["its"] == ref["its"]
    assert abs(port["fnorm"] - ref["fnorm"]) <= 1e-12 * max(1.0, np.linalg.norm(ref["x"]))
    np.testing.assert_allclose(port["x"], ref["x"], rtol=0, atol=1e-10 * np.abs(ref["x"]).max())


def run_linesearch(B, lstype):
    snes = B.pt.SNES().create()
    snes.setType("newtonls")
    snes.linesearch.kind = lstype

    def F(x):
        return x ** 3 + 2.0 * x - 4.0 + 0.5 * B.xp.roll(x, 1)

    snes.setFunction(F)
    x = B.pt.Vec.from_array(np.zeros(8))
    snes.solve(None, x)
    return snes_record(snes, x)


@pytest.mark.parametrize("lstype", ["secant", "bisection", "nleqerr", "basic", "l2", "cp"])
def test_linesearch_variants(lstype):
    port, ref = both(run_linesearch, lstype)
    assert port["reason"] > 0
    assert_snes_same(port, ref)


def test_ex5_residual_jvp_matches_fd():
    """The ported ex5 residual (written out of place) carries its tangent:
    torch.func.jvp against a central difference in f64."""
    da = pt_da(17)
    F = ex5_port.make_residual(da, 6.0)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.random(17 * 17) * 0.3)
    v = torch.as_tensor(rng.standard_normal(17 * 17))
    jv = torch.func.jvp(F, (x,), (v,))[1]
    h = 1e-6
    fd = (F(x + h * v) - F(x - h * v)) / (2 * h)
    assert torch.linalg.norm(jv - fd) <= 1e-7 * torch.linalg.norm(jv)
    # and the residual equals the reference's
    ref = np.asarray(ex5_jax.make_residual(JAX.pt.DMDA.create(2, (17, 17)), 6.0)(
        JAX.arr(host(x))))
    np.testing.assert_allclose(host(F(x)), ref, rtol=1e-14, atol=1e-14)


def pt_da(n):
    return TORCH.pt.DMDA.create(2, (n, n))


def run_ex5_gamg(B, n=65, lam=6.0):
    """chip_smoke.py's ex5 case (CG + GAMG, KSP rtol 1e-5, max_it 200,
    ex5.c's initial guess) at 65^2, the smallest grid where CG + GAMG
    converges on every Newton step in both packages."""
    ex5 = EX5[B.name]
    da = B.pt.DMDA.create(2, (n, n), dof=1, stencil_width=1)
    snes = B.pt.SNES().create()
    snes.setDM(da)
    snes.setFunction(ex5.make_residual(da, lam))
    snes.setJacobian(ex5.make_jacobian(da, lam), J=da.createMatrix())
    ksp = snes.getKSP()
    ksp.setType("cg")
    ksp.getPC().setType("gamg")
    ksp.setTolerances(rtol=1e-5, max_it=200)
    x = da.createGlobalVector()
    x.setArray(ex5_port.initial_guess(da, lam) if B is TORCH else
               ex5_port.initial_guess(TORCH.pt.DMDA.create(2, (n, n)), lam))
    snes.solve(None, x)
    out = snes_record(snes, x)
    out["levels"] = [int(lev.A.getSize()[0]) for lev in ksp.getPC()._impl.levels]
    return out


def test_ex5_cg_gamg_coarsens_the_2d_grid_as_the_reference():
    """The structured head coarsens ex5's 2-D grid (padded to three axes on
    the card) as the reference's does, 65^2 -> 33^2, before the aggregation
    tail (216, 29 rows), and Newton's history is the reference's."""
    port, ref = both(run_ex5_gamg)
    assert port["levels"] == ref["levels"] == [4225, 1089, 216, 29]
    assert port["reason"] > 0
    assert_snes_same(port, ref)


def test_repeated_coo_pattern_keeps_the_plan():
    """ex5's Jacobian callback calls setPreallocationCOO every Newton step:
    the same (i, j) again keeps the COO plan and the device layout, and
    setValuesCOO then replaces every value as after a fresh
    preallocation; a changed pattern builds a new plan."""
    da = pt_da(9)
    ii, jj, _ = ex5_port.jacobian_pattern(da)
    rng = np.random.default_rng(3)
    A = TORCH.pt.MatAIJ()
    A.setSizes((81, 81))
    A.setStencilGrid((9, 9))
    A.setPreallocationCOO(ii, jj)
    plan = A._coo_plan
    A.setValuesCOO(rng.random(len(ii)))
    v2 = rng.random(len(ii))
    A.setPreallocationCOO(ii.copy(), jj.copy())
    assert A._coo_plan is plan
    assert A.to_scipy().count_nonzero() == 0       # zero, as a fresh call leaves it
    assert float(A.device_data()["diag"].abs().max()) == 0.0
    A.setValuesCOO(v2)
    B = TORCH.pt.MatAIJ()
    B.setSizes((81, 81))
    B.setStencilGrid((9, 9))
    B.setPreallocationCOO(ii, jj)
    B.setValuesCOO(v2)
    assert A.meta[0] == B.meta[0] == "aij_dnd"
    np.testing.assert_array_equal(A.to_scipy().toarray(), B.to_scipy().toarray())
    A.setPreallocationCOO(ii[:-1], jj[:-1])
    assert A._coo_plan is not plan
