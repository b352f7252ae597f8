"""The wrapper Mats of petsc_tpu_torch (mat/utility.py, mat/extra_formats.py)
against petsc_tpu on the CPU (mirrors tests/test_mat_utility.py and the
FFT and KAIJ cases of tests/test_inventory_fills.py): MatTranspose,
MatNormal, MatDiagonal, MatComposite, MatLRC, MatCentering, MatNest,
MatSchurComplement, MatMAIJ (on M1's plain version), MatPreallocator,
MatIS, MatLocalRef, MatFFT and MatKAIJ; the CSR transpose product through
the explicit transpose, also after a value change; and interop's
mat_from_jax.

Both packages get the same seeded numpy inputs (the reference with
-mat_spmv_kind csr where a wrapper's inner operator is carried by
interop). Tolerances: products to 1e-12 relative; solves with the same
iterations and reason, histories to 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.mat import extra_formats as rx
from petsc_tpu.mat import utility as ru
from petsc_tpu.ops import operator as rop
from petsc_tpu_torch import interop
from petsc_tpu_torch.mat import extra_formats as px
from petsc_tpu_torch.mat import utility as pu
from petsc_tpu_torch.ops import operator as pop
from petsc_tpu_torch.ops import pallas_kernels as pk
from tests.test_mg_gamg import poisson2d

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

TOL = 1e-12
HIST_RTOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _init(args=()):
    pt_jax.init(args=["-mat_spmv_kind", "csr", *args])
    ptt.init(args=list(args), device="cpu")


def _nonsym():
    A = poisson2d(6).tolil()
    A[0, 5] = -2.5
    A[7, 30] = 0.75
    return A.tocsr()


def _both(A_sp):
    return pt_jax.MatAIJ.from_scipy(A_sp), ptt.MatAIJ.from_scipy(A_sp)


def _apply_both(Mj, Mp, x, transpose=False):
    oj = rop.bind(Mj.meta, Mj.device_data())
    op = pop.bind(Mp.meta, Mp.device_data())
    yj = (oj.mult_t if transpose else oj.mult)(jnp.asarray(x))
    yp = (op.mult_t if transpose else op.mult)(torch.as_tensor(x))
    return np.asarray(yj), yp.numpy()


def test_transpose_and_normal():
    _init()
    A_sp = _nonsym()
    Aj, Ap = _both(A_sp)
    x = np.random.default_rng(0).random(36)
    for cj, cp, want in ((ru.MatTranspose, pu.MatTranspose, A_sp.T @ x),
                         (ru.MatNormal, pu.MatNormal, A_sp.T @ (A_sp @ x))):
        yj, yp = _apply_both(cj.create(Aj), cp.create(Ap), x)
        assert _rel(yp, want) <= TOL and _rel(yp, yj) <= TOL
    # the transpose's transpose is A
    yj, yp = _apply_both(ru.MatTranspose.create(Aj), pu.MatTranspose.create(Ap), x,
                         transpose=True)
    assert _rel(yp, A_sp @ x) <= TOL


def test_diagonal_centering_and_lrc():
    _init()
    d = np.arange(1.0, 11.0)
    yj, yp = _apply_both(ru.MatDiagonal.create(d), pu.MatDiagonal.create(d), np.ones(10))
    assert np.array_equal(yp, yj) and np.array_equal(yp, d)
    x = np.arange(9.0)
    yj, yp = _apply_both(ru.MatCentering.create(9), pu.MatCentering.create(9), x)
    assert _rel(yp, x - x.mean()) <= TOL and _rel(yp, yj) <= TOL
    A_sp = poisson2d(5)
    Aj, Ap = _both(A_sp)
    rng = np.random.default_rng(3)
    U, V, C = rng.random((25, 3)), rng.random((25, 3)), rng.random((3, 3))
    x = rng.random(25)
    for args in ((U, C, V), (U, None, None)):
        Mj, Mp = ru.MatLRC.create(Aj, *args), pu.MatLRC.create(Ap, *args)
        yj, yp = _apply_both(Mj, Mp, x)
        Ce = np.eye(3) if args[1] is None else C
        Ve = U if args[2] is None else V
        assert _rel(yp, A_sp @ x + U @ (Ce @ (Ve.T @ x))) <= TOL and _rel(yp, yj) <= TOL
    yj, yp = _apply_both(ru.MatLRC.create(None, U, C, V), pu.MatLRC.create(None, U, C, V), x)
    assert _rel(yp, yj) <= TOL


@pytest.mark.parametrize("ctype", ["additive", "multiplicative"])
def test_composite(ctype):
    _init()
    A_sp, B_sp = poisson2d(5), 0.5 * _nonsym()[:25, :25]
    (Aj, Ap), (Bj, Bp) = _both(A_sp), _both(B_sp.tocsr())
    x = np.random.default_rng(2).random(25)
    yj, yp = _apply_both(ru.MatComposite.create([Aj, Bj], ctype),
                         pu.MatComposite.create([Ap, Bp], ctype), x)
    want = (A_sp + B_sp) @ x if ctype == "additive" else B_sp @ (A_sp @ x)
    assert _rel(yp, want) <= TOL and _rel(yp, yj) <= TOL


def test_nest_uses_the_blocks_offsets():
    _init()
    A_sp = poisson2d(4)
    B_sp = sp.random(16, 8, density=0.4, random_state=5, format="csr")
    D_sp = sp.eye(8, format="csr") * 2.0
    blocks = [_both(A_sp), _both(B_sp), _both(D_sp)]
    Nj = ru.MatNest.create([[blocks[0][0], blocks[1][0]], [None, blocks[2][0]]])
    Np = pu.MatNest.create([[blocks[0][1], blocks[1][1]], [None, blocks[2][1]]])
    assert Np.getSize() == (24, 24)
    x = np.random.default_rng(4).random(24)
    full = np.block([[A_sp.toarray(), B_sp.toarray()], [np.zeros((8, 16)), D_sp.toarray()]])
    yj, yp = _apply_both(Nj, Np, x)
    assert _rel(yp, full @ x) <= TOL and _rel(yp, yj) <= TOL


def test_normal_operator_drives_cg_as_the_reference():
    # shifted: the normal equations square the condition number, and on
    # _nonsym() itself CG takes all 36 steps, its two packages' histories
    # parting by rounding after about 22 (the reference's test checks x only)
    A_sp = (_nonsym() + 4.0 * sp.eye(36)).tocsr()
    xstar = np.random.default_rng(6).random(36)
    b = A_sp.T @ (A_sp @ xstar)
    out = {}
    for name, pkg, mod in (("jax", pt_jax, ru), ("port", ptt, pu)):
        _init()
        N = mod.MatNormal.create(pkg.MatAIJ.from_scipy(A_sp))
        ksp = pkg.KSP().create()
        ksp.setOperators(N)
        ksp.setType("cg")
        ksp.getPC().setType("none")
        ksp.setTolerances(rtol=1e-10, max_it=500)
        x = N.createVecRight()
        ksp.solve(pkg.Vec.from_array(b), x)
        out[name] = (ksp.getIterationNumber(), ksp.getConvergedReason().name,
                     np.asarray(ksp.getConvergenceHistory()), np.asarray(x.getArray()))
    assert out["port"][:2] == out["jax"][:2]
    assert _rel(out["port"][2], out["jax"][2]) <= HIST_RTOL
    assert out["port"][0] < 30
    assert np.allclose(out["port"][3], xstar, atol=1e-6)


def test_schur_complement_as_the_reference():
    """The implicit S equals the dense Schur complement, its inner KSP
    configured through getKSP before the first use, and S drives an outer
    GMRES as in the reference."""
    n0, n1 = 14, 6
    F = sp.diags([4.0] * n0) + sp.random(n0, n0, density=0.2, random_state=1) * 0.1
    F = ((F + F.T) * 0.5).tocsr()
    Bt = sp.random(n0, n1, density=0.4, random_state=2, format="csr")
    Bm = sp.csr_matrix(Bt.T)
    C = sp.eye(n1, format="csr") * 0.3
    Sd = C.toarray() - Bm.toarray() @ np.linalg.solve(F.toarray(), Bt.toarray())
    x = np.random.default_rng(5).random(n1)
    out = {}
    for name, pkg, mod in (("jax", pt_jax, ru), ("port", ptt, pu)):
        _init()
        blocks = [pkg.MatAIJ.from_scipy(M) for M in (F, Bt, Bm, C)]
        S = mod.MatSchurComplement.create(*blocks)
        assert S.getSubMatrices()[0] is blocks[0]
        S.getKSP().setType("cg")
        S.getKSP().setTolerances(rtol=1e-12)
        y = S.createVecLeft()
        S.mult(pkg.Vec.from_array(x), y)
        ksp = pkg.KSP().create()
        ksp.setOperators(S)
        ksp.setType("gmres")
        ksp.getPC().setType("none")
        ksp.setTolerances(rtol=1e-10)
        xs = S.createVecRight()
        ksp.solve(pkg.Vec.from_array(np.ones(n1)), xs)
        out[name] = (np.asarray(y.getArray()), ksp.getIterationNumber(),
                     ksp.getConvergedReason().name, np.asarray(xs.getArray()))
    assert np.allclose(out["port"][0], Sd @ x, atol=1e-8)
    assert _rel(out["port"][0], out["jax"][0]) <= 1e-9
    assert out["port"][1:3] == out["jax"][1:3] and out["port"][2].startswith("CONVERGED")
    assert np.allclose(Sd @ out["port"][3], 1.0, atol=1e-7)


@pytest.mark.parametrize("dof", [1, 3])
def test_maij_products_on_m1_equal_the_reference(dof):
    _init()
    A_sp = _nonsym()
    Aj, Ap = _both(A_sp)
    Mj, Mp = ru.MatMAIJ.create(Aj, dof), pu.MatMAIJ.create(Ap, dof)
    assert Mp.getAIJ() is Ap and Mp.getSize() == (36 * dof, 36 * dof)
    x = np.random.default_rng(dof).standard_normal(36 * dof)
    X = x.reshape(36, dof)
    pk.reset_launches()
    yj, yp = _apply_both(Mj, Mp, x)
    assert _rel(yp, (A_sp @ X).reshape(-1)) <= TOL and _rel(yp, yj) <= TOL
    yj, yp = _apply_both(Mj, Mp, x, transpose=True)
    assert _rel(yp, (A_sp.T @ X).reshape(-1)) <= TOL and _rel(yp, yj) <= TOL
    # a length that is not a multiple of dof is truncated to one, as in the
    # reference: a tail shorter than dof is dropped
    if dof > 1:
        yj, yp = _apply_both(Mj, Mp, np.concatenate([x, [5.0] * (dof - 1)]), transpose=True)
        assert yp.shape == yj.shape == (36 * dof,) and _rel(yp, (A_sp.T @ X).reshape(-1)) <= TOL
        assert _rel(yp, yj) <= TOL
    assert pk.LAUNCHES["csr_spmm"] == 0            # the CPU: M1's plain version


def test_maij_over_a_grid_operator_goes_by_component():
    """A MAIJ over a non-CSR operator (a stencil on aij_dnd) applies its
    own product to each component."""
    ptt.init(device="cpu")
    from petsc_tpu_torch.ops import stencil_build
    A_sp = stencil_build.poisson3d_27pt(5)
    A = ptt.MatAIJ.from_scipy(A_sp, grid=(5, 5, 5))
    assert A.meta[0] == "aij_dnd"
    M = pu.MatMAIJ.create(A, 2)
    x = np.random.default_rng(1).standard_normal(250)
    y = M.createVecLeft()
    M.mult(ptt.Vec.from_array(x), y)
    assert _rel(y.getArray(), (A_sp @ x.reshape(125, 2)).reshape(-1)) <= TOL


def test_csr_transpose_product_uses_an_explicit_transpose_refreshed_on_value_change():
    ptt.init(device="cpu")
    rng = np.random.default_rng(7)
    A_sp = sp.random(40, 30, density=0.2, random_state=7, format="csr")
    coo = A_sp.tocoo()
    A = ptt.MatAIJ()
    A.setSizes((40, 30))
    A.setPreallocationCOO(coo.row, coo.col)
    A.setValuesCOO(coo.data)
    x = rng.standard_normal(40)
    y = A.createVecRight()
    A.multTranspose(ptt.Vec.from_array(x), y)
    assert _rel(y.getArray(), A_sp.T @ x) <= TOL
    data = A.device_data()
    tptr, trow, tvals = data["csr_t"][0], data["csr_t"][1], data["csr_t_vals"]
    At = A_sp.T.tocsr()
    assert np.array_equal(tptr.numpy(), At.indptr) and np.array_equal(trow.numpy(), At.indices)
    assert np.array_equal(tvals.numpy(), At.data)
    # new values on the same pattern: the transposed values follow, the
    # pattern is kept
    v2 = rng.standard_normal(len(coo.data))
    A.setValuesCOO(v2)
    assert "csr_t_vals" not in A.device_data() and A.device_data()["csr_t"][0] is tptr
    A.multTranspose(ptt.Vec.from_array(x), y)
    B = sp.csr_matrix((v2, (coo.row, coo.col)), shape=(40, 30))
    assert _rel(y.getArray(), B.T @ x) <= TOL
    # a host value change rebuilds the device copy and its transpose
    A.scale(2.0)
    A.multTranspose(ptt.Vec.from_array(x), y)
    assert _rel(y.getArray(), 2.0 * (B.T @ x)) <= TOL


def test_preallocator_and_local_ref():
    out = {}
    for name, pkg, mod in (("jax", pt_jax, ru), ("port", ptt, pu)):
        _init()
        P = mod.MatPreallocator.create(6)
        P.setValues([0, 1], [0, 2])
        P.setValues([5], [4, 5])
        P.assemble()
        B = pkg.MatAIJ()
        B.setSizes(6)
        P.preallocate(B)
        pat = B.to_scipy()
        parent = pkg.MatAIJ.from_scipy(poisson2d(3))
        L = mod.MatLocalRef.create(parent, [1, 4, 7], [0, 4])
        L.setValues([0], [1], [[9.0]])
        L.assemble()
        sub = np.asarray(pop.bind(L.meta, L.device_data()).mult(torch.ones(2, dtype=torch.float64)) if pkg is ptt
                         else rop.bind(L.meta, L.device_data()).mult(jnp.ones(2)))
        out[name] = (pat.indptr, pat.indices, pat.nnz, parent.to_scipy().toarray(), sub)
    for a, b in zip(out["port"], out["jax"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert out["port"][3][1, 4] == 9.0


def test_mat_is_unassembled_as_the_reference():
    n = 9
    kl = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(5, 5)).toarray()
    kl[0, 0] = kl[-1, -1] = 1.0
    maps = [np.arange(0, 5), np.arange(4, 9)]
    x = np.random.default_rng(0).random(n)
    out = {}
    for name, pkg, mod in (("jax", pt_jax, ru), ("port", ptt, pu)):
        _init()
        M = mod.MatIS.create(n, [kl, kl], maps)
        S = M.assemble_global().to_scipy().toarray()
        y = M.createVecLeft()
        M.mult(pkg.Vec.from_array(x), y)
        Ms = mod.MatIS.create(n, [kl + np.eye(5), kl + np.eye(5)], maps)
        ksp = pkg.KSP().create()
        ksp.setOperators(Ms)
        ksp.setType("cg")
        ksp.getPC().setType("none")
        ksp.setTolerances(rtol=1e-10)
        xs = Ms.createVecRight()
        ksp.solve(pkg.Vec.from_array(np.ones(n)), xs)
        out[name] = (S, np.asarray(y.getArray()), M.interface_multiplicity(),
                     ksp.getIterationNumber(), np.asarray(xs.getArray()))
    S = out["port"][0]
    assert S[4, 4] == 2.0 and S[3, 3] == 2.0 and np.array_equal(S, out["jax"][0])
    assert _rel(out["port"][1], S @ x) <= TOL and _rel(out["port"][1], out["jax"][1]) <= TOL
    assert np.array_equal(out["port"][2], out["jax"][2]) and out["port"][2][4] == 2.0
    assert out["port"][3] == out["jax"][3]
    assert _rel(out["port"][4], out["jax"][4]) <= 1e-9


def test_fft_as_the_reference():
    n = 16
    x = np.random.default_rng(0).random(n)
    Mj, Mp = rx.MatFFT.create(n), px.MatFFT.create(n)
    oj = rop.bind(Mj.meta, Mj.device_data())
    op = pop.bind(Mp.meta, Mp.device_data())
    yp = op.mult(torch.as_tensor(x)).numpy()
    assert _rel(yp, np.fft.fft(x)) <= TOL and _rel(yp, np.asarray(oj.mult(jnp.asarray(x)))) <= TOL
    back = op.mult_t(torch.as_tensor(yp)).numpy() / n
    assert _rel(back, x) <= TOL


@pytest.mark.parametrize("which", ["both", "S", "T"])
def test_kaij_as_the_reference(which):
    _init()
    A_sp = _nonsym()
    Aj, Ap = _both(A_sp)
    S = np.array([[2.0, 0.0, 0.1], [0.0, 3.0, 0.0], [0.2, 0.0, 1.0]])
    T = np.array([[1.0, 0.5, 0.0], [0.0, 1.0, 0.3], [0.1, 0.0, 1.0]])
    Sa, Ta = (S, T) if which == "both" else ((S, None) if which == "S" else (None, T))
    Kj, Kp = rx.MatKAIJ.create(Aj, Sa, Ta), px.MatKAIJ.create(Ap, Sa, Ta)
    x = np.random.default_rng(1).random(36 * 3)
    X = x.reshape(36, 3)
    ref = np.zeros_like(X)
    if Sa is not None:
        ref += X @ S.T
    if Ta is not None:
        ref += (A_sp @ X) @ T.T
    yj, yp = _apply_both(Kj, Kp, x)
    assert _rel(yp, ref.reshape(-1)) <= TOL and _rel(yp, yj) <= TOL


def test_interop_carries_reference_mats():
    _init()
    A_sp = _nonsym()
    rng = np.random.default_rng(9)
    x = rng.standard_normal(36)
    Aj = pt_jax.MatAIJ.from_scipy(A_sp)
    wrappers = [ru.MatTranspose.create(Aj), ru.MatNormal.create(Aj),
                ru.MatComposite.create([Aj, Aj], "multiplicative"),
                ru.MatLRC.create(Aj, rng.random((36, 2)), rng.random((2, 2))),
                ru.MatDiagonal.create(np.arange(36.0)), ru.MatCentering.create(36),
                pt_jax.Mat.createDense((36, 36), array=A_sp.toarray()),
                pt_jax.MatSBAIJ.from_scipy(A_sp + A_sp.T)]
    for Mj in wrappers:
        Mp = interop.mat_from_jax(Mj)
        assert type(Mp).__name__ == type(Mj).__name__
        yj, yp = _apply_both(Mj, Mp, x)
        assert _rel(yp, yj) <= TOL, type(Mj).__name__
    Mj = ru.MatMAIJ.create(Aj, 2)
    yj, yp = _apply_both(Mj, interop.mat_from_jax(Mj), rng.standard_normal(72))
    assert _rel(yp, yj) <= TOL
    Kj = rx.MatKAIJ.create(Aj, np.eye(2), 0.5 * np.ones((2, 2)))
    yj, yp = _apply_both(Kj, interop.mat_from_jax(Kj), rng.standard_normal(72))
    assert _rel(yp, yj) <= TOL
    SBp = interop.mat_from_jax(wrappers[-1])
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(SBp.upper_csr(), wrappers[-1].upper_csr()))
