"""MatShell, MatDense, the createDense/createShell/createStencil factories,
MatAIJ.convert("dense") and KSP.matSolve's MatDense of petsc_tpu_torch
against petsc_tpu on the CPU (mirrors tests/test_mat.py test_shell and
test_dense, and tests/test_ksp_matsolve_guess.py test_matsolve).

Both packages get the same seeded numpy inputs. Tolerances: products to
1e-12 relative (sums in another order); solves with the same iterations
and reason, histories to 1e-6 relative."""

import jax
import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import stencil_build

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

TOL = 1e-12
HIST_RTOL = 1e-6
PKGS = {"jax": pt_jax, "port": ptt}


def _init(pkg, args=()):
    if pkg is ptt:
        ptt.init(args=list(args), device="cpu")
    else:
        pt_jax.init(args=list(args))


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _arr(pkg, x):
    return np.asarray(x.getArray() if hasattr(x, "getArray") else x, dtype=np.float64)


def _apply(pkg, M, x, transpose=False):
    y = M.createVecRight() if transpose else M.createVecLeft()
    (M.multTranspose if transpose else M.mult)(pkg.Vec.from_array(x), y)
    return _arr(pkg, y)


def _solve(pkg, A, args, b):
    _init(pkg, ["-ksp_rtol", "1e-10", "-ksp_max_it", "500", *args])
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(b), x)
    return (ksp.getIterationNumber(), ksp.getConvergedReason().name,
            np.asarray(ksp.getConvergenceHistory()), _arr(pkg, x))


def _same_solves(a, b):
    assert a[:2] == b[:2]
    assert a[2].shape == b[2].shape and _rel(a[2], b[2]) <= HIST_RTOL


def test_shell_mult_as_the_reference():
    n = 8
    x = np.arange(float(n))
    for pkg in PKGS.values():
        _init(pkg)
        M = pkg.Mat.createShell((n, n), mult=lambda v: 2.0 * v)
        np.testing.assert_allclose(_apply(pkg, M, x), 2.0 * x)
        assert M.meta[0] == "shell"


def test_shell_context_is_passed_only_when_given():
    n = 6
    x = np.arange(1.0, n + 1.0)
    ptt.init(device="cpu")
    M = ptt.Mat.createShell(n, mult=lambda ctx, v: ctx["s"] * v, context={"s": 3.0})
    np.testing.assert_allclose(_apply(ptt, M, x), 3.0 * x)
    M = ptt.Mat.createShell(n, mult=lambda v: -v, mult_transpose=lambda v: 5.0 * v)
    np.testing.assert_allclose(_apply(ptt, M, x), -x)
    np.testing.assert_allclose(_apply(ptt, M, x, transpose=True), 5.0 * x)


@pytest.mark.parametrize("pc", ["jacobi", "none"])
def test_cg_on_a_shell_equals_cg_on_its_matrix(pc):
    """A shell whose mult is an assembled matrix's operator and whose diag
    is its diagonal solves as the matrix does, in both packages."""
    A_sp = stencil_build.poisson3d_27pt(8)
    b = np.cos(0.01 * np.arange(A_sp.shape[0]))
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatAIJ.from_scipy(A_sp)
        op = A.op()
        S = pkg.Mat.createShell(A.getSize(), mult=op.mult, diag=op.diag)
        args = ["-ksp_type", "cg", "-pc_type", pc]
        out[name] = (_solve(pkg, A, args, b), _solve(pkg, S, args, b))
    for name in PKGS:
        _same_solves(out[name][1], out[name][0])
    _same_solves(out["port"][1], out["jax"][1])
    assert _rel(out["port"][1][3], out["jax"][1][3]) <= 1e-8


def test_dense_products_diagonal_and_norms():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((7, 9))
    x, xt = rng.standard_normal(9), rng.standard_normal(7)
    res = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        M = pkg.Mat.createDense((7, 9), array=a)
        norms = [M.norm(t) for t in (pkg.NormType.NORM_FROBENIUS, pkg.NormType.NORM_1,
                                     pkg.NormType.NORM_INFINITY)]
        res[name] = (_apply(pkg, M, x), _apply(pkg, M, xt, transpose=True),
                     np.asarray(M.getDenseArray()), norms, M.meta)
    assert _rel(res["port"][0], res["jax"][0]) <= TOL
    assert _rel(res["port"][1], res["jax"][1]) <= TOL
    assert np.array_equal(res["port"][2], res["jax"][2])
    np.testing.assert_allclose(res["port"][3], res["jax"][3], rtol=TOL)
    assert res["port"][4] == ("dense", 7, 9)
    # the diagonal of a square one
    sq = rng.standard_normal((5, 5))
    ptt.init(device="cpu")
    D = ptt.Mat.createDense(5, array=sq)
    np.testing.assert_array_equal(D.getDiagonal().getArray(), np.diag(sq))


def test_convert_dense_equals_the_reference():
    import scipy.sparse as sp
    A_sp = stencil_build.poisson3d_27pt(4)
    A_sp = (A_sp + sp.triu(0.1 * np.ones(A_sp.shape), 1)).tocsr()
    dense = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        D = pkg.MatAIJ.from_scipy(A_sp).convert("dense")
        assert type(D).__name__ == "MatDense"
        dense[name] = np.asarray(D.getDenseArray())
    assert np.array_equal(dense["port"], dense["jax"])
    with pytest.raises(ValueError):
        ptt.MatAIJ.from_scipy(stencil_build.poisson3d_27pt(2)).convert("sell")


def test_create_stencil_takes_the_grid_layout_and_solves_as_the_reference():
    grid = (6, 7, 8)
    offsets = [(0, 0, 0), (0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0)]
    rng = np.random.default_rng(3)
    coeffs = -0.5 - rng.random((len(offsets),) + grid)
    coeffs[0] = 8.0 + rng.random(grid)
    for k, off in enumerate(offsets):          # zero the couplings that leave the grid
        for ax, d in enumerate(off):
            sl = [slice(None)] * 3
            if d == 0:
                continue
            sl[ax] = slice(0, -d) if d < 0 else slice(grid[ax] - d, None)
            coeffs[k][tuple(sl)] = 0.0
    b = np.sin(0.1 * np.arange(np.prod(grid)))
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.Mat.createStencil(grid, offsets, coeffs)
        out[name] = (A.meta[0], _apply(pkg, A, b), A.to_scipy().toarray(),
                     _solve(pkg, A, ["-ksp_type", "gmres", "-pc_type", "jacobi"], b))
    assert out["port"][0] == "aij_dnd"
    assert np.array_equal(out["port"][2], out["jax"][2])
    assert _rel(out["port"][1], out["jax"][1]) <= TOL
    _same_solves(out["port"][3], out["jax"][3])


def test_matsolve_returns_a_dense_mat_as_the_reference():
    """tests/test_ksp_matsolve_guess.py test_matsolve on both packages."""
    from tests.test_mg_gamg import poisson2d
    A_sp = poisson2d(12)
    Xstar = np.random.default_rng(0).random((144, 5))
    B = A_sp @ Xstar
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatAIJ.from_scipy(A_sp)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setType("cg")
        ksp.getPC().setType("jacobi")
        ksp.setTolerances(rtol=1e-10, max_it=500)
        X = ksp.matSolve(B)
        assert type(X).__name__ == "MatDense" and X.getSize() == (144, 5)
        assert ksp.getConvergedReason().converged
        out[name] = (np.asarray(X.getDenseArray()), ksp.getIterationNumber(),
                     ksp.getConvergedReason().name)
        # a MatDense given as B, and a MatDense given as X
        Bm = pkg.Mat.createDense((144, 5), array=B)
        Xm = pkg.Mat.createDense((144, 5))
        assert ksp.matSolve(Bm, Xm) is Xm
        assert np.allclose(np.asarray(Xm.getDenseArray()), Xstar, atol=1e-6)
    assert out["port"][1:] == out["jax"][1:]
    assert np.allclose(out["port"][0], Xstar, atol=1e-6)
    assert _rel(out["port"][0], out["jax"][0]) <= 1e-8
