"""eisenstat, kaczmarz, redundant, mat, deflation, galerkin, vpbjacobi, svd,
telescope, lmvm, qr and spai against the JAX package on the CPU, on the
reference tests' inputs (tests/test_pc_extras.py, tests/test_ksp_pc_r3.py):
iteration counts and reasons equal, histories to 1e-6 relative (rounding-
level entries to 1e-11 of the initial norm); preonly solves by their
solutions."""

import numpy as np
import pytest
import scipy.sparse as sp

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from tests.pc_parity import assert_parity, run_both, solve
from tests.test_ksp_pc_r3 import _nonsym
from tests.test_mg_gamg import poisson2d


def test_eisenstat_matches_the_reference():
    run_both("eisenstat", poisson2d(24), ksp_type="cg")


def test_eisenstat_omega_and_no_diagonal_scaling_match_the_reference():
    run_both("eisenstat", poisson2d(16), args=["-pc_eisenstat_omega", "1.3",
                                               "-pc_eisenstat_no_diagonal_scaling"])


def test_kaczmarz_matches_the_reference():
    # 600 of the reference test's 2000 steps: the histories agree to 1e-6
    # of each entry only so far (summation order compounds over the run)
    run_both("kaczmarz", poisson2d(12), max_it=600, rtol=1e-6)


def test_redundant_matches_the_reference():
    port, _ = run_both("redundant", poisson2d(24))
    assert port[0] <= 2


def test_pcmat_matches_the_reference():
    def setup(pc, pkg):
        if pkg is ptt:
            from petsc_tpu_torch.mat.utility import MatDiagonal
        else:
            from petsc_tpu.mat.utility import MatDiagonal
        pc._impl.setMat(MatDiagonal.create(1.0 / pc.pmat.to_scipy().diagonal()))
    run_both("mat", poisson2d(24), ksp_type="cg", setup=setup)


def test_deflation_matches_the_reference():
    n = 24
    xs = np.arange(n) / (n - 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    W = np.stack([np.ones(n * n), X.ravel(), Y.ravel(), (X * Y).ravel()], axis=1)
    run_both("deflation", poisson2d(n), ksp_type="cg", setup=lambda pc, pkg: pc._impl.setSpace(W))


def test_galerkin_inside_composite_matches_the_reference():
    n, c = 16, 4
    rows = np.arange(n * n)
    cols = (rows // n // c) * (n // c) + (rows % n) // c
    P = sp.csr_matrix((np.ones(n * n), (rows, cols)), shape=(n * n, (n // c) ** 2))

    def setup(pc, pkg):
        pc._impl.ctype = "additive"
        pc._impl.addPC("sor")
        pc._impl.addPC("galerkin")._impl.setInterpolation(pkg.MatAIJ.from_scipy(P))
    run_both("composite", poisson2d(n), ksp_type="cg", setup=setup)


def test_vpbjacobi_matches_the_reference():
    from tests.test_baij import block_matrix
    A = block_matrix(n=8, bs=3)
    A = ((A + A.T) * 0.5).tocsr()
    run_both("vpbjacobi", A, ksp_type="cg",
             setup=lambda pc, pkg: pc._impl.setBlockSizes(np.full(A.shape[0] // 3, 3)))


@pytest.mark.parametrize("pc_type", ["svd", "telescope", "lmvm"])
def test_small_dense_and_wrapper_pcs_match_the_reference(pc_type):
    run_both(pc_type, poisson2d(12))


def test_lmvm_with_pairs_matches_the_reference():
    A = poisson2d(10)
    rng = np.random.default_rng(2)
    S = [rng.random(A.shape[0]) for _ in range(3)]

    def setup(pc, pkg):
        for s in S:
            pc._impl.update(s, A @ s)
    run_both("lmvm", A, setup=setup)


@pytest.mark.parametrize("singular", [False, True])
def test_qr_matches_the_reference(singular):
    A, b, _ = _nonsym(150 if not singular else 100)
    if singular:
        A = A.tolil()
        A[:, 0] = 0
        A[0, :] = 0
        A = A.tocsr()
    args = ["-ksp_type", "preonly", "-pc_type", "qr"]
    port, ref = solve(ptt, args, A_sp=A, b=b), solve(pt_jax, args, A_sp=A, b=b)
    assert np.all(np.isfinite(port[3]))
    assert np.max(np.abs(port[3] - ref[3])) <= 1e-10 * np.max(np.abs(ref[3]))


@pytest.mark.parametrize("pat", ["same", "power2"])
def test_spai_matches_the_reference(pat):
    A, b, _ = _nonsym(200)
    args = ["-ksp_type", "gmres", "-pc_type", "spai", "-pc_spai_pattern", pat]
    tol = {"rtol": 1e-10, "max_it": 300}
    assert_parity(solve(ptt, args, A_sp=A, b=b, tol=tol), solve(pt_jax, args, A_sp=A, b=b, tol=tol))
