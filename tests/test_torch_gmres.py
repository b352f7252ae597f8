"""petsc_tpu_torch's GMRES, FGMRES, BiCGStab and MINRES with the
factorization PCs (ilu, icc, lu, cholesky, bjacobi, sor) against the JAX
package: the same operator (BASELINE config 2's stencil7, at small sizes,
or the tutorials' systems), the same options and right-hand side, both
packages driven through their user API.

Tolerances: iteration counts and converged reasons are equal; residual
histories agree to 1e-6 relative and solutions to 1e-7 (f64: the two
packages sum in other orders; the Krylov recurrences amplify the last
bits); a direct solve's solutions to 1e-10; the ex2 tutorial's residuals to
the 1e-3 of tests/test_tutorials_ksp.py; a MINRES history entry at the
rounding level (its last, where the Krylov space of the 40-unknown system
is complete) to 1e-11 of the initial norm. Under -real_dtype f32 the
histories agree to F32_HIST_ATOL of the initial norm, measured from f32
runs of both packages (see that constant)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch import interop
from petsc_tpu_torch.ops import stencil_build

torch.set_num_threads(1)

HIST_TOL = 1e-6
# -real_dtype f32, box27 rtol 1e-6, b = 1, both packages on the CPU
# (f32_parity.py): the largest gap between their histories, over the
# initial norm, was 2.7e-6 (CG+Jacobi 16^3), 2.4e-6 (CG+none 16^3), 6.6e-8
# (GMRES+ILU 16^3), 4.5e-7, 6.9e-7 and 3.1e-8 at 12^3. Relative to each
# entry the last ones differ by up to 0.14 (GMRES 16^3): at 1e-6 of the
# initial norm a float32 history is rounding, not signal. The bound keeps a
# factor of about 4 over the largest.
F32_HIST_ATOL = 1e-5


def _stencil7(shape, jitter=True):
    i, j, v = stencil_build.stencil7_coo(*shape, jitter=jitter)
    n = int(np.prod(shape))
    return sp.csr_matrix((v, (i, j)), shape=(n, n))


def _solve(pkg, A_sp, args, b, device=None):
    """One solve through the package's API: init with `args`, MatAIJ from
    the scipy matrix, KSP with setFromOptions; returns (ksp, x)."""
    if device is None:
        pkg.init(args=args)
    else:
        pkg.init(args=args, device=device)
    A = pkg.MatAIJ.from_scipy(A_sp)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(b), x)
    return ksp, np.asarray(x.getArray() if pkg is pt_jax else x.array.cpu().numpy())


def _both(A_sp, args, b=None):
    if b is None:
        b = A_sp @ np.cos(0.01 * np.arange(A_sp.shape[0]))
    kj, xj = _solve(pt_jax, A_sp, args, b)
    kp, xp = _solve(ptt, A_sp, args, b, device="cpu")
    return (kj, xj[:A_sp.shape[0]]), (kp, xp)


def _agree(j, p, hist_tol=HIST_TOL, x_tol=1e-7):
    (kj, xj), (kp, xp) = j, p
    assert kp.getType() == kj.getType() and kp.getPC().getType() == kj.getPC().getType()
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert len(hp) == len(hj)
    np.testing.assert_allclose(hp, hj, rtol=hist_tol, atol=0)
    np.testing.assert_allclose(xp, xj, rtol=0, atol=x_tol * np.abs(xj).max())


def test_defaults_give_gmres_and_ilu_on_config_2():
    """BASELINE config 2's operator at 6 x 60 x 60 with no type set:
    GMRES(30) + ILU(0) in both packages, the same 11 iterations."""
    j, p = _both(_stencil7((6, 60, 60)), ["-ksp_rtol", "1e-8", "-ksp_max_it", "400"])
    assert p[0].getType() == "gmres" and p[0].getPC().getType() == "ilu"
    assert p[0].getIterationNumber() == 11
    assert p[0].getConvergedReason() == ptt.KSPConvergedReason.CONVERGED_RTOL
    _agree(j, p)


OPTIONS = {
    "restart 5, jacobi": ["-pc_type", "jacobi", "-ksp_gmres_restart", "5"],
    "refine_ifneeded": ["-ksp_gmres_cgs_refinement_type", "refine_ifneeded"],
    "refine_always, restart 3": ["-ksp_gmres_cgs_refinement_type", "refine_always",
                                 "-ksp_gmres_restart", "3"],
    "ilu(1)": ["-pc_factor_levels", "1"],
    "ilu(2)": ["-pc_factor_levels", "2"],
    "icc": ["-pc_type", "icc"],
    "iludt": ["-pc_factor_drop_tolerance", "1e-3", "-pc_factor_fill", "5"],
    "bjacobi 4": ["-pc_type", "bjacobi", "-pc_bjacobi_blocks", "4"],
    "bjacobi 3, sub lu": ["-pc_type", "bjacobi", "-pc_bjacobi_blocks", "3",
                          "-sub_pc_type", "lu"],
    "bjacobi 2, sub jacobi": ["-pc_type", "bjacobi", "-pc_bjacobi_blocks", "2",
                              "-sub_pc_type", "jacobi"],
    "sor": ["-pc_type", "sor"],
    "sor forward, omega 1.2": ["-pc_type", "sor", "-pc_sor_forward", "-pc_sor_omega", "1.2"],
    "sor backward": ["-pc_type", "sor", "-pc_sor_backward"],
    "bcgs": ["-ksp_type", "bcgs"],
    "bcgs, unpreconditioned norm": ["-ksp_type", "bcgs", "-ksp_norm_type", "unpreconditioned"],
    "fgmres by pc side right": ["-ksp_pc_side", "right"],
    "fgmres, restart 4": ["-ksp_type", "fgmres", "-ksp_gmres_restart", "4"],
    "max_it 7, none": ["-pc_type", "none", "-ksp_max_it", "7"],
}


@pytest.mark.parametrize("name", OPTIONS)
def test_solvers_and_preconditioners_match_the_reference(name):
    j, p = _both(_stencil7((3, 8, 10)), ["-ksp_rtol", "1e-8", *OPTIONS[name]])
    if name.startswith("fgmres by"):
        assert p[0].getType() == "fgmres"
    if name == "max_it 7, none":
        assert p[0].getConvergedReason() == ptt.KSPConvergedReason.DIVERGED_ITS
    _agree(j, p)


@pytest.mark.parametrize("pc", ("lu", "cholesky"))
def test_preonly_direct_solves_match_the_reference(pc):
    A = _stencil7((3, 7, 9), jitter=pc == "lu")      # cholesky on the symmetric operator
    j, p = _both(A, ["-ksp_type", "preonly", "-pc_type", pc])
    assert p[0].getIterationNumber() == j[0].getIterationNumber() == 1
    b = A @ np.cos(0.01 * np.arange(A.shape[0]))
    assert np.linalg.norm(A @ p[1] - b) <= 1e-13 * np.linalg.norm(b)
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=1e-10)


@pytest.mark.parametrize("norm,reason", (("preconditioned", "CONVERGED_ATOL"),
                                         ("none", "CONVERGED_HAPPY_BREAKDOWN")))
def test_happy_breakdown_matches_the_reference(norm, reason):
    """A diagonal operator with three distinct values: the Krylov space is
    exhausted after three steps, and with a residual below 1 the happy
    breakdown test (tt < min(|tt / rs|, HAPTOL)) ends the solve there. The
    residual is then set to 0, which the default test takes as
    CONVERGED_ATOL; with no norm it is CONVERGED_HAPPY_BREAKDOWN."""
    d = np.tile([1.0, 2.0, 3.0], 40)
    j, p = _both(sp.diags(d).tocsr(), ["-pc_type", "none", "-ksp_rtol", "1e-30",
                                       "-ksp_norm_type", norm],
                 b=np.linspace(1.0, 2.0, 120) * 1e-3)
    assert p[0].getIterationNumber() == 3 and p[0].getConvergedReason().name == reason
    _agree(j, p)


def _ex2_history(pkg, device=None):
    """examples/ex2.py's 5 x 5 system with -ksp_gmres_cgs_refinement_type
    refine_always and every other option at its default (GMRES + ILU)."""
    args = ["-m", "5", "-n", "5", "-ksp_gmres_cgs_refinement_type", "refine_always"]
    pkg.init(args=args) if device is None else pkg.init(args=args, device=device)
    m = n = 5
    A = pkg.MatAIJ()
    A.setSizes((m * n, m * n))
    ADD = pkg.InsertMode.ADD_VALUES
    for Ii in range(m * n):
        i, j = Ii // n, Ii % n
        for jj, ok in ((Ii - n, i > 0), (Ii + n, i < m - 1), (Ii - 1, j > 0), (Ii + 1, j < n - 1)):
            if ok:
                A.setValue(Ii, jj, -1.0, ADD)
        A.setValue(Ii, Ii, 4.0, ADD)
    A.assemble()
    u = A.createVecRight()
    u.set(1.0)
    b = A.createVecLeft()
    A.mult(u, b)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setTolerances(rtol=1.e-2 / ((m + 1) * (n + 1)), atol=1.e-50)
    ksp.setFromOptions()
    x = A.createVecRight()
    ksp.solve(b, x)
    x.axpy(-1.0, u)
    return ksp.getType(), ksp.getIterationNumber(), ksp.getConvergenceHistory(), float(x.norm())


def test_ex2_gmres_ilu_refine_always_gives_the_tutorials_residuals():
    """tests/test_tutorials_ksp.py:18-34 (PETSc's output/ex2_1.out)."""
    typ, its, hist, err = _ex2_history(ptt, device="cpu")
    assert typ == "gmres" and its == 4
    np.testing.assert_allclose(hist, [3.21109, 0.93268, 0.103515, 0.00787798, 0.000387275],
                               rtol=1e-3)
    assert abs(err - 0.000392701) <= 1e-3 * 0.000392701
    _, its_j, hist_j, err_j = _ex2_history(pt_jax)
    assert its_j == its
    np.testing.assert_allclose(hist, hist_j, rtol=HIST_TOL, atol=0)


def test_minres_on_the_indefinite_system_matches_the_reference():
    """tests/test_ksp_basic.py:139's system: symmetric, eigenvalues in
    [-5, -1] and [1, 5]."""
    n = 40
    rng = np.random.RandomState(5)
    Q = np.linalg.qr(rng.randn(n, n))[0]
    evals = np.concatenate([np.linspace(-5, -1, n // 2), np.linspace(1, 5, n - n // 2)])
    Ad = (Q * evals) @ Q.T
    bvec = rng.randn(n)
    args = ["-ksp_type", "minres", "-pc_type", "none", "-ksp_rtol", "1e-10",
            "-ksp_max_it", "500"]
    j, p = _both(sp.csr_matrix(Ad), args, b=bvec)
    assert p[0].getConvergedReason().converged and p[0].getIterationNumber() == n
    np.testing.assert_allclose(Ad @ p[1], bvec, atol=1e-7)
    hj, hp = j[0].getConvergenceHistory(), p[0].getConvergenceHistory()
    np.testing.assert_allclose(hp[:-1], hj[:-1], rtol=HIST_TOL, atol=0)
    assert abs(hp[-1] - hj[-1]) <= 1e-11 * hj[0]
    assert p[0].getConvergedReason().name == j[0].getConvergedReason().name
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=1e-7 * np.abs(j[1]).max())


@pytest.mark.parametrize("extra", ([], ["-pc_factor_drop_tolerance", "1e-3"], "lu"))
def test_the_transpose_solve_matches_the_reference(extra):
    """-pc_factor_transpose_solve: PC.applyTranspose in both packages on the
    same vector, and (B^T y, x) = (y, B x)."""
    A = _stencil7((3, 8, 10))
    pc_type = "lu" if extra == "lu" else "ilu"
    args = ["-pc_type", pc_type, "-pc_factor_transpose_solve",
            *([] if extra == "lu" else extra)]
    rng = np.random.default_rng(2)
    xv, yv = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    out = {}
    for pkg in (pt_jax, ptt):
        pkg.init(args=args) if pkg is pt_jax else pkg.init(args=args, device="cpu")
        M = pkg.MatAIJ.from_scipy(A)
        pc = pkg.PC().create()
        pc.setOperators(M)
        pc.setFromOptions()
        bx = pc.apply(pkg.Vec.from_array(xv))
        bty = pc.applyTranspose(pkg.Vec.from_array(yv))
        get = (lambda v: np.asarray(v.getArray())[:A.shape[0]]) if pkg is pt_jax \
            else (lambda v: v.array.numpy())
        out[pkg.__name__] = (get(bx), get(bty))
    (jx, jt), (px, ptr) = out["petsc_tpu"], out["petsc_tpu_torch"]
    np.testing.assert_allclose(px, jx, rtol=1e-12, atol=1e-12 * np.abs(jx).max())
    np.testing.assert_allclose(ptr, jt, rtol=1e-12, atol=1e-12 * np.abs(jt).max())
    assert abs(ptr @ xv - yv @ px) <= 1e-10 * abs(yv @ px)


def test_get_factor_solves_match_the_reference():
    A = _stencil7((3, 6, 7))
    b = np.linspace(-1.0, 1.0, A.shape[0])
    for kind in ("lu", "ilu"):
        res = []
        for pkg in (pt_jax, ptt):
            pkg.init() if pkg is pt_jax else pkg.init(device="cpu")
            F = pkg.MatAIJ.from_scipy(A).getFactor("petsc", kind)
            F.factorSymbolic()
            F.factorNumeric()
            x = F.solve(pkg.Vec.from_array(b))
            res.append(np.asarray(x.getArray() if pkg is pt_jax else x.array.numpy())[:len(b)])
        np.testing.assert_allclose(res[1], res[0], rtol=0, atol=1e-12 * np.abs(res[0]).max())
    assert np.linalg.norm(A @ res[1] - b) > 0   # ilu is not the exact inverse


@pytest.fixture
def reference_back_to_f64():
    """The reference keeps -real_dtype f32 in force after a later init
    without it (a reference fault, ROADMAP section 3), so the tests that
    run after one that sets it would run in float32: set float64 back."""
    yield
    pt_jax.set_real_dtype("f64")


@pytest.mark.parametrize("ksp_type,pc_type", (("cg", "jacobi"), ("gmres", "ilu")))
def test_f32_solves_match_the_reference(ksp_type, pc_type, reference_back_to_f64):
    """-real_dtype f32 on box27 16^3, rtol 1e-6, b = 1: the same its and
    reason, histories in float32 in both packages, agreeing to F32_HIST_ATOL
    of the initial norm."""
    args = ["-ksp_type", ksp_type, "-pc_type", pc_type, "-ksp_rtol", "1e-6",
            "-real_dtype", "f32"]
    A = stencil_build.poisson3d_27pt(16)
    b = np.ones(A.shape[0])
    kj, _ = _solve(pt_jax, A, args, b)
    kp, _ = _solve(ptt, A, args, b, device="cpu")
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert hp.dtype == np.float32 and np.asarray(hj).dtype == np.float32
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"
    np.testing.assert_allclose(hp, hj, rtol=0, atol=F32_HIST_ATOL * float(hj[0]))


def test_the_default_and_ported_types_set_without_raising():
    ptt.init(device="cpu")
    A = ptt.MatAIJ.from_scipy(_stencil7((2, 3, 4)))
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    for t in ("gmres", "fgmres", "bcgs", "minres"):
        ksp.setType(t)
        assert ksp.getType() == t
    for t in ("ilu", "icc", "lu", "cholesky", "bjacobi", "sor"):
        ksp.getPC().setType(t)
        ksp.getPC().setUp()
        assert ksp.getPC().getType() == t
    ksp.setGMRESRestart(7)
    ksp.setType("gmres")
    assert ksp._static_cfg().extra == (7, 0)
    ksp.setPCSide("right")
    ksp.setUp()
    assert ksp.getType() == "fgmres"


def test_what_this_slice_leaves_out_raises_naming_the_roadmap():
    """What this slice once refused, -pc_factor_trisolve neumann and bjacobi
    with an iterative -sub_ksp_type, now solves as the JAX package does
    (the same its, reason and history to 1e-6); nothing names the ROADMAP."""
    A_sp = _stencil7((2, 3, 4))
    b = A_sp @ np.cos(0.01 * np.arange(A_sp.shape[0]))
    for args in (["-pc_type", "ilu", "-pc_factor_trisolve", "neumann"],
                 ["-ksp_type", "fgmres", "-pc_type", "bjacobi", "-pc_bjacobi_blocks", "2",
                  "-sub_ksp_type", "gmres", "-sub_pc_type", "jacobi"]):
        out = []
        for pkg in (ptt, pt_jax):
            if pkg is ptt:
                ptt.init(args=args + ["-ksp_rtol", "1e-8"], device="cpu")
            else:
                pt_jax.init(args=args + ["-ksp_rtol", "1e-8"])
            A = pkg.MatAIJ.from_scipy(A_sp)
            ksp = pkg.KSP().create()
            ksp.setOperators(A)
            ksp.setFromOptions()
            x = A.createVecRight()
            ksp.solve(pkg.Vec.from_array(b), x)
            out.append((ksp.getIterationNumber(), ksp.getConvergedReason().name,
                        np.asarray(ksp.getConvergenceHistory())))
        (its, reason, h), (its_j, reason_j, h_j) = out
        assert (its, reason) == (its_j, reason_j) and reason == "CONVERGED_RTOL"
        assert np.all(np.abs(h - h_j) <= 1e-6 * h_j + 1e-11 * h_j[0])


def test_a_plan_carried_from_the_reference_applies_as_the_ports_pc():
    """The reference's ILU(0) plan through interop gives the port's PC
    application on the same operator, bit for bit."""
    from petsc_tpu.mat import factor as factor_jax
    from petsc_tpu.ops import trisolve as ts_jax
    from petsc_tpu_torch.ops import trisolve
    A = _stencil7((3, 9, 8))
    tail, data = ts_jax.make_trisolve_plan(*factor_jax.ilu0(A.indptr, A.indices, A.data))
    ptt.init(args=["-pc_type", "ilu"], device="cpu")
    _, pdata = interop.trisolve_plan_from_jax(tail, {k: np.asarray(v) for k, v in data.items()})
    pc = ptt.PC().create()
    pc.setOperators(ptt.MatAIJ.from_scipy(A))
    pc.setFromOptions()
    b = torch.linspace(-1.0, 2.0, A.shape[0], dtype=torch.float64)
    assert torch.equal(pc.op().mult(b), trisolve.trisolve_apply(pdata, b))
