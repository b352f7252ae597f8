"""PCMG and the sparse products of MatAIJ in petsc_tpu_torch against
petsc_tpu: matMult, transposeMatMult, ptap, rart and createSubMatrix;
PCMG with user interpolation (the reference's geometric test), the host
Chebyshev bounds of each level, CG+PCMG on the box27 operator with the Q1
Galerkin hierarchy that chip_smoke.py drives at 128^3, one application of
each cycle type, smoother and coarse solver, the float32 cycle, and the
refusals of what later slices bring.

Tolerances: products and the host bounds equal to 1e-12 relative (the
same C++ on both sides); one PC application to 1e-12 in float64 and
1e-5 in float32; solver histories to 1e-6 relative with equal iteration
counts and reasons."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.pc import mg as mg_jax
from petsc_tpu_torch.ops import stencil_build
from petsc_tpu_torch.pc import mg
from petsc_tpu_torch.sys.error import Error

torch.set_num_threads(1)

# CG+PCMG on box27 n^3 (b = 1, x0 = 0, rtol 1e-8), Q1 Galerkin hierarchy
# down to 8^3: the reference's iteration counts
CONTRACT_ITS = {16: 7, 32: 8}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _init(pkg, args=()):
    if pkg is ptt:
        ptt.init(args=list(args), device="cpu")
    else:
        pt_jax.init(args=list(args))


# ------------------------------------------------------------------ Mat products

def _rand(m, n, seed, density=0.2):
    return sp.random(m, n, density=density, format="csr", random_state=seed)


PRODUCTS = {
    "matMult": lambda A, B, C: A.matMult(B),
    "transposeMatMult": lambda A, B, C: A.transposeMatMult(C),
    "ptap": lambda A, B, C: A.ptap(B),
    "rart": lambda A, B, C: A.rart(B),           # B is then R, 12 x 30
    "createSubMatrix": lambda A, B, C: A.createSubMatrix([3, 1, 7, 20, 8], [0, 5, 9]),
}


@pytest.mark.parametrize("name", PRODUCTS)
def test_mat_products_match_the_reference(name):
    A_sp, B_sp, C_sp = _rand(30, 30, 1), _rand(30, 12, 2), _rand(30, 9, 3)
    out = []
    for pkg in (pt_jax, ptt):
        _init(pkg)
        A, B, C = (pkg.MatAIJ.from_scipy(M) for M in (A_sp, B_sp, C_sp))
        if name == "rart":
            B = pkg.MatAIJ.from_scipy(B_sp.T.tocsr())
        out.append(PRODUCTS[name](A, B, C).to_scipy())
    want, got = out
    assert got.shape == want.shape
    assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.indices, want.indices)
    assert _rel(got.data, want.data) <= 1e-12


# ------------------------------------------------------------------ PCMG

def test_mg_galerkin_geometric():
    """tests/test_mg_gamg.py::test_mg_galerkin_geometric in both packages:
    1-D Poisson, P the linear interpolation onto the n/2 grid, the coarse
    operator by Galerkin RAP."""
    n = 64
    A_sp = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1],
                    format="csr")
    nc = n // 2
    rows, cols, vals = [], [], []
    for j in range(nc):
        fi = 2 * j + 1
        rows += [fi, fi - 1, min(fi + 1, n - 1)]
        cols += [j, j, j]
        vals += [1.0, 0.5, 0.5]
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, nc))
    res = []
    for pkg in (pt_jax, ptt):
        _init(pkg)
        A = pkg.MatAIJ.from_scipy(A_sp)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setType("cg")
        pc = ksp.getPC()
        pc.setType("mg")
        pc._impl.setLevels(2)
        pc._impl.setInterpolation(0, pkg.MatAIJ.from_scipy(P))
        ksp.setTolerances(rtol=1e-8, max_it=50)
        u = A.createVecRight()
        u.set(1.0)
        b = A.createVecLeft()
        A.mult(u, b)
        x = A.createVecRight()
        ksp.solve(b, x)
        assert ksp.getConvergedReason().converged
        x.axpy(-1.0, u)
        assert float(x.norm()) < 1e-6
        res.append(ksp)
    _assert_same_solve(*res)


def _assert_same_solve(kj, kp):
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert hp.shape == hj.shape
    np.testing.assert_allclose(hp, hj, rtol=1e-6, atol=0)


def _mg_ksp(pkg, n, args=(), coarsest=8):
    """CG+PCMG on box27 n^3 with chip_smoke.py's Q1 hierarchy, set up."""
    _init(pkg, ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8", *args])
    A = pkg.MatAIJ.from_scipy(stencil_build.poisson3d_27pt(n))
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    _, Ps = chip_smoke.q1_hierarchy(n, coarsest)
    impl = ksp.getPC()._impl
    impl.setLevels(len(Ps) + 1)
    for l, P in enumerate(Ps):
        impl.setInterpolation(l, pkg.MatAIJ.from_scipy(P))
    ksp.setUp()
    return ksp, A


def _solve(ksp, A):
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return np.asarray(x.getArray())[: A.getSize()[0]]


@pytest.mark.parametrize("nf", (8, 9, 16, 17))
def test_q1_interpolation_is_the_reference_transfer(nf):
    """chip_smoke.py's kron(P1, P1, P1) is the reference's Q1 prolongation
    (petsc_tpu/dm/interp.py) on an nf^3 grid."""
    from petsc_tpu.dm.interp import _interp_axis
    nc = (nf + 1) // 2
    P1 = chip_smoke.q1_interp(nf)
    P = sp.kron(P1, sp.kron(P1, P1)).tocsr()
    xc = np.random.default_rng(nf).random((nc, nc, nc))
    want = jnp.asarray(xc)
    for ax in range(3):
        want = _interp_axis(want, ax, nf)
    assert _rel(P @ xc.reshape(-1), np.asarray(want).reshape(-1)) <= 1e-15


@pytest.mark.parametrize("n", sorted(CONTRACT_ITS))
def test_cg_pcmg_box27_matches_the_reference(n):
    kj, Aj = _mg_ksp(pt_jax, n)
    xj = _solve(kj, Aj)
    kp, Ap = _mg_ksp(ptt, n)
    xp = _solve(kp, Ap)
    assert kp.getIterationNumber() == CONTRACT_ITS[n]
    assert kp.getConvergedReason().name == "CONVERGED_RTOL"
    _assert_same_solve(kj, kp)
    assert np.linalg.norm(xp - xj) <= 1e-9 * np.linalg.norm(xj)
    levels_j, levels_p = kj.getPC()._impl.levels, kp.getPC()._impl.levels
    assert [lev.A.nnz() for lev in levels_p] == [lev.A.nnz() for lev in levels_j]
    assert [lev.emax for lev in levels_p] == [lev.emax for lev in levels_j]


def test_host_emax_matches_the_reference_on_every_level():
    kp, _ = _mg_ksp(ptt, 32)
    for lev in kp.getPC()._impl.levels:
        A_sp = lev.A.to_scipy()
        dinv = 1.0 / A_sp.diagonal()
        got = mg._host_emax(A_sp, dinv)
        want = mg_jax._host_emax(A_sp, dinv)
        assert abs(got - want) <= 1e-12 * want


def test_host_eig_bounds_match_the_reference():
    A_sp = stencil_build.poisson3d_27pt(6)
    dinv = 1.0 / A_sp.diagonal()
    got = mg._host_eig_bounds(lambda v: A_sp @ v, dinv, A_sp.shape[0])
    want = mg_jax._host_eig_bounds(lambda v: A_sp @ v, dinv, A_sp.shape[0])
    assert _rel(got, want) <= 1e-12


CYCLES = {
    "v": [],
    "w": ["-pc_mg_cycle_type", "w"],
    "full": ["-pc_mg_type", "full"],
    "kaskade": ["-pc_mg_type", "kaskade"],
    "coarse_cg": ["-mg_coarse_ksp_type", "cg", "-mg_coarse_pc_type", "jacobi"],
    "fourth": ["-mg_levels_ksp_type", "fourth"],
    "opt_fourth": ["-mg_levels_ksp_type", "opt_fourth"],
    "richardson": ["-mg_levels_ksp_type", "richardson"],
    "three_sweeps": ["-mg_levels_ksp_max_it", "3"],
}


@pytest.mark.parametrize("name", CYCLES)
def test_one_pc_application_matches_the_reference(name):
    """Three levels (16^3, 8^3, 4^3), one application to a random vector."""
    r = np.random.default_rng(5).random(16 ** 3) - 0.5
    kj, _ = _mg_ksp(pt_jax, 16, CYCLES[name], coarsest=4)
    want = np.asarray(kj.getPC().op().mult(jnp.asarray(r)))[: r.size]
    kp, _ = _mg_ksp(ptt, 16, CYCLES[name], coarsest=4)
    got = kp.getPC().op().mult(torch.as_tensor(r)).numpy()
    assert len(kp.getPC()._impl.levels) == 3
    assert _rel(got, want) <= 1e-12


def test_the_f32_cycle_matches_the_reference():
    args = ["-pc_mg_dtype", "single"]
    kj, Aj = _mg_ksp(pt_jax, 32, args)
    kp, Ap = _mg_ksp(ptt, 32, args)
    r = np.random.default_rng(9).random(32 ** 3) - 0.5
    want = np.asarray(kj.getPC().op().mult(jnp.asarray(r)))[: r.size]
    got = kp.getPC().op().mult(torch.as_tensor(r))
    assert got.dtype == torch.float64              # the boundary casts back
    assert _rel(got.numpy(), want) <= 1e-5
    _solve(kj, Aj)
    _solve(kp, Ap)
    assert kp.getIterationNumber() == kj.getIterationNumber() == CONTRACT_ITS[32]
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"


def test_what_later_slices_bring_is_refused():
    # -pc_gamg_asm_use_agg smooths with aggregate blocks
    # where GAMG made aggregates; PCMG's levels have none, so they keep
    # Jacobi, as in the reference
    k_agg, A_agg = _mg_ksp(ptt, 8, ["-pc_gamg_asm_use_agg"], coarsest=4)
    k_jac, A_jac = _mg_ksp(ptt, 8, [], coarsest=4)
    _solve(k_agg, A_agg)
    _solve(k_jac, A_jac)
    assert k_agg.getIterationNumber() == k_jac.getIterationNumber()
    assert np.array_equal(k_agg.getConvergenceHistory(), k_jac.getConvergenceHistory())
    # no levels and no DM
    ptt.init(args=["-ksp_type", "cg", "-pc_type", "mg"], device="cpu")
    A = ptt.MatAIJ.from_scipy(stencil_build.poisson3d_27pt(4))
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    with pytest.raises(Error, match="setLevels"):
        ksp.setUp()
    # a DM attached to the operator that is not a DMDA: a clear refusal
    A._dm = object()
    with pytest.raises(Error, match="not a DMDA"):
        ksp.setUp()
    # a DMDA's matrix: the reference's levels (sizes, Galerkin operators)
    from examples import ex45 as ex45_jax
    from petsc_tpu_torch.examples import ex45 as ex45_port
    levels = []
    for pkg, ex in ((pt_jax, ex45_jax), (ptt, ex45_port)):
        _init(pkg, ["-ksp_type", "cg", "-pc_type", "mg"])
        da = pkg.DMDA.create(3, (9, 9, 9))
        A = da.createMatrix()
        ex.compute_operators(None, A, A)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        ksp.setUp()
        levels.append([lev.A.to_scipy() for lev in ksp.getPC()._impl.levels])
    assert [L.shape[0] for L in levels[1]] == [L.shape[0] for L in levels[0]] == [729, 125, 27]
    for Lp, Lj in zip(*levels[::-1]):
        assert _rel(Lp.toarray(), Lj.toarray()) <= 1e-12
