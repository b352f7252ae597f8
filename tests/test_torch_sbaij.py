"""MatSBAIJ of petsc_tpu_torch against petsc_tpu on the CPU (mirrors
tests/test_sbaij.py): the upper-triangle host storage, the folding of
lower-triangle entries, symmetric element assembly, the product and CG,
the block-size trap (``bs`` gives no block size), and PETSc's ex56 built
as a MatSBAIJ against the same problem as a BAIJ at ne 4 and 8.

Tolerances: the stored triangles and expanded matrices equal; products
to 1e-12 relative; solves with the same iterations, reason and
hierarchy, histories to 1e-6 relative."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch.examples import ex56
from petsc_tpu_torch.vec.vec import InsertMode
from tests.test_mg_gamg import poisson2d

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


def test_from_scipy_stores_the_upper_triangle_and_multiplies_as_the_reference():
    A0 = poisson2d(8)
    x = np.random.default_rng(0).random(A0.shape[0])
    res = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatSBAIJ.from_scipy(A0)
        y = pkg.Vec.from_array(np.zeros(A0.shape[0]))
        A.mult(pkg.Vec.from_array(x), y)
        assert A.isSymmetric()
        res[name] = (np.asarray(y.getArray()), [np.asarray(a) for a in A.upper_csr()],
                     A.to_scipy().toarray())
    assert _rel(res["port"][0], A0 @ x) <= TOL
    assert _rel(res["port"][0], res["jax"][0]) <= TOL
    for a, b in zip(res["port"][1], res["jax"][1]):
        assert np.array_equal(a, b)
    assert len(res["port"][1][2]) < A0.nnz
    assert np.array_equal(res["port"][2], res["jax"][2])


def test_bs_gives_no_block_size():
    """The reference keeps the bs argument as _bs_sym only (sbaij.py:30-33):
    the device layout stays the bs-1 CSR until setBlockSize."""
    A0 = sp.kron(poisson2d(4), np.ones((3, 3)) + 3 * np.eye(3), format="csr")
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatSBAIJ.from_scipy(A0, bs=3)
        assert A._bs_sym == 3 and A.getBlockSize() == 1
        if pkg is ptt:
            assert A.meta[0] == "aij_csr"
            A.setBlockSize(3)
            assert A.meta == ("aij_bsr", 48, 48, 3)
            y = A.createVecLeft()
            x = np.arange(48.0)
            A.mult(ptt.Vec.from_array(x), y)
            assert _rel(y.getArray(), A0 @ x) <= TOL


def test_setvalues_lower_entries_are_folded():
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatSBAIJ.create(4)
        A.setValues([0], [0], [[2.0]])
        A.setValues([2], [1], [[-1.0]])       # lower: stored at (1, 2)
        A.setValues([3], [3], [[1.5]])
        A.assemble()
        out[name] = (A.to_scipy().toarray(), [np.asarray(a) for a in A.upper_csr()])
    D = out["port"][0]
    assert D[1, 2] == -1.0 and D[2, 1] == -1.0 and D[0, 0] == 2.0
    assert np.array_equal(D, out["jax"][0])
    for a, b in zip(out["port"][1], out["jax"][1]):
        assert np.array_equal(a, b)


def test_add_values_element_loop_keeps_the_upper_copy():
    ref = np.zeros((4, 4))
    ke = np.array([[2.0, -1.0], [-1.0, 2.0]])
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg)
        A = pkg.MatSBAIJ.create(4)
        ref[:] = 0.0
        for e in ((0, 1), (1, 2), (2, 3)):
            idx = np.array(e)
            A.setValues(idx, idx, ke, addv=InsertMode.ADD_VALUES)
            ref[np.ix_(idx, idx)] += ke
        A.assemble()
        out[name] = A.to_scipy().toarray()
    assert np.allclose(out["port"], ref) and np.array_equal(out["port"], out["jax"])


def test_setvalues_csr_drops_the_lower_part():
    A0 = poisson2d(5)
    U = sp.triu(A0).tocsr()
    for full in (A0, U):
        _init(ptt)
        A = ptt.MatSBAIJ.create(25)
        A.setValuesCSR(full.indptr, full.indices, full.data)
        A.assemble()
        ip, ix, v = A.upper_csr()
        assert np.array_equal(ip, U.indptr) and np.array_equal(ix, U.indices)
        assert np.array_equal(A.to_scipy().toarray(), A0.toarray())


def test_a_second_assembly_keeps_the_matrix_symmetric():
    """After an assembled matrix takes more entries, the upper triangle of
    the merged CSR is expanded (the reference expands the merged full CSR,
    doubling the off-diagonal entries: ROADMAP section 3)."""
    _init(ptt)
    A = ptt.MatSBAIJ.create(3)
    A.setValues([0, 1], [0, 1], [[2.0, -1.0], [-1.0, 2.0]])
    A.assemble()
    A.setValues([2], [2], [[5.0]])
    A.setValues([2], [1], [[-0.5]])
    A.assemble()
    want = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, -0.5], [0.0, -0.5, 5.0]])
    assert np.array_equal(A.to_scipy().toarray(), want)
    x = np.array([1.0, 2.0, 3.0])
    y = A.createVecLeft()
    A.mult(ptt.Vec.from_array(x), y)
    assert np.allclose(y.getArray(), want @ x)


def test_sbaij_in_ksp_solves_as_the_reference():
    A0 = poisson2d(10)
    out = {}
    for name, pkg in PKGS.items():
        _init(pkg, ["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10"])
        A = pkg.MatSBAIJ.from_scipy(A0)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        b = pkg.Vec.from_array(np.ones(A0.shape[0]))
        x = A.createVecRight()
        ksp.solve(b, x)
        out[name] = (ksp.getIterationNumber(), ksp.getConvergedReason().name,
                     np.asarray(ksp.getConvergenceHistory()), np.asarray(x.getArray()))
    assert out["port"][:2] == out["jax"][:2] and out["port"][1] == "CONVERGED_RTOL"
    assert _rel(out["port"][2], out["jax"][2]) <= HIST_RTOL
    assert np.linalg.norm(A0 @ out["port"][3] - 1.0) < 1e-7


def _ex56(pkg, ne, sbaij, A_sp, b_np, coords):
    _init(pkg, ["-ksp_type", "cg", "-pc_type", "gamg"])
    A = (pkg.MatSBAIJ if sbaij else pkg.MatAIJ).from_scipy(A_sp)
    A.setBlockSize(3)
    A.setNearNullSpace(pkg.MatNullSpace.createRigidBody(coords)._dense)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setNormType("unpreconditioned")
    ksp.setTolerances(rtol=1e-4, max_it=200)
    ksp.setFromOptions()
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(b_np), x)
    levels = ksp.getPC()._impl.levels
    return {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
            "history": np.asarray(ksp.getConvergenceHistory()),
            "rows": [lev.A.getSize()[0] for lev in levels],
            "agg0": np.asarray(levels[0].agg), "F": A.to_scipy()}


@pytest.mark.parametrize("ne", [4, 8])
def test_ex56_as_sbaij_equals_ex56_as_baij(ne):
    """PETSc's ex56 at the defaults with the operator built as
    MatSBAIJ.from_scipy of the assembled CSR: the same iterations,
    hierarchy, level-0 aggregates and history as the BAIJ build, in the
    reference and in the port. The expanded CSR is the BAIJ's nonzeros
    (the assembly's explicit zeros dropped, as the reference drops them),
    each lower entry its upper mirror."""
    A_sp, b_np, coords = ex56.assemble(ne)
    runs = {(name, sb): _ex56(pkg, ne, sb, A_sp, b_np, coords)
            for name, pkg in PKGS.items() for sb in (False, True)}
    for key in runs:
        r, base = runs[key], runs[("jax", False)]
        assert (r["its"], r["reason"], r["rows"]) == (base["its"], base["reason"], base["rows"])
        assert np.array_equal(r["agg0"], base["agg0"])
        assert _rel(r["history"], base["history"]) <= HIST_RTOL
    F = runs[("port", True)]["F"]
    U = sp.triu(A_sp).tocsr()
    U.eliminate_zeros()
    want = (U + sp.triu(U, 1).T).tocsr()
    assert F.nnz == want.nnz < A_sp.nnz
    assert (F != want).nnz == 0
    assert abs(F - A_sp).max() <= 1e-15 * abs(A_sp).max()
    assert (F != runs[("jax", True)]["F"]).nnz == 0
