"""petsc_tpu_torch's petsc4py namespace (petsc4py_compat.PETSc), its
top-level names, IS, ISLocalToGlobalMapping and AO against petsc_tpu, on
the CPU, after tests/test_compat.py and tests/test_ao_partition_ghost.py's
AO test.

Tolerances: index sets and orderings equal; the petsc4py-style solve's
iterations equal and its solution to 1e-10; the binary files equal in
bytes."""

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.parallel.ao import AO as RAO
from petsc_tpu.parallel.index import IS as RIS, LGMap as RLGMap
from petsc_tpu.petsc4py_compat import PETSc as RPETSc
from petsc_tpu_torch.parallel.ao import AO
from petsc_tpu_torch.parallel.index import IS, LGMap
from petsc_tpu_torch.petsc4py_compat import PETSc
from tests.test_mg_gamg import poisson2d

torch.set_num_threads(1)


def _init(args=()):
    pt_jax.init(args=list(args))
    ptt.init(args=list(args), device="cpu")


def test_petsc4py_style_solve_and_viewer(tmp_path):
    _init()
    A_sp = poisson2d(12)
    out = []
    for P, tag in ((RPETSc, "r"), (PETSc, "p")):
        A = P.Mat().createAIJ(A_sp.shape, csr=(A_sp.indptr, A_sp.indices, A_sp.data))
        b = P.Vec().createWithArray(np.ones(A_sp.shape[0]))
        x = b.duplicate()
        ksp = P.KSP().create()
        ksp.setOperators(A)
        ksp.setType(P.KSP.Type.CG)
        ksp.getPC().setType("jacobi")
        ksp.setTolerances(rtol=1e-10)
        ksp.solve(b, x)
        assert ksp.getConvergedReason() > 0 and ksp.getConvergedReason() == \
            P.KSP.ConvergedReason.CONVERGED_RTOL
        vw = P.Viewer.createBinary(str(tmp_path / f"{tag}.dat"), "w")
        vw.view(A)
        vw.view(x if tag == "r" else P.Vec().createWithArray(out[0][1]))
        B = P.Viewer.createBinary(str(tmp_path / f"{tag}.dat"), "r").load()
        assert (A.to_scipy() != B.to_scipy()).nnz == 0
        out.append((ksp.getIterationNumber(), np.asarray(x.getArray())[:144]))
    assert out[0][0] == out[1][0] and np.max(np.abs(out[0][1] - out[1][1])) <= 1e-10
    assert (tmp_path / "p.dat").read_bytes() == (tmp_path / "r.dat").read_bytes()


def test_petsc4py_options_and_factories():
    _init(["-foo", "42", "-bar", "2.5", "-baz", "qq", "-flag"])
    o = PETSc.Options()
    assert (o.getInt("foo"), o.getReal("bar"), o.getString("baz"), o.getBool("flag")) == \
        (42, 2.5, "qq", True)
    o.setValue("foo", 7)
    assert PETSc.Options().getInt("foo") == 7
    v = PETSc.Vec().createSeq(5)
    assert v.getSize() == 5 and v.array.device.type == "cpu"
    D = PETSc.Mat().createDense((3, 2), array=np.arange(6.0).reshape(3, 2))
    assert np.array_equal(D.getDenseArray(), np.arange(6.0).reshape(3, 2))

    class Ctx:
        def mult(self, mat, x):
            return 2 * x
    S = PETSc.Mat().createPython((4, 4), context=Ctx())
    assert S.getSize() == (4, 4)


def test_compat_extended_namespace():
    _init()
    ao = PETSc.AO.createBasic([3, 1, 0, 2])
    assert isinstance(ao, AO)
    for name in ("DMNetwork", "DMStag", "DMSwarm", "DMComposite", "DMPlex", "DMDA", "IS",
                 "Random", "Bag", "PC", "SNES", "TS", "TAO"):
        obj = getattr(PETSc, name)()
        assert type(obj).__module__.startswith("petsc_tpu_torch"), name
    assert PETSc.DMDA.create(2, (5, 5)).N == 25
    with PETSc.Log.Stage("CompatStage"):
        ev = PETSc.Log.Event("CompatEvent")
        ev.begin()
        ev.end()
    assert ptt.config.log().get_event("CompatEvent", "CompatStage") is not None


def test_top_level_names():
    """The reference's petsc_tpu/__init__.py:34-35 and :43-100 names; VecGhost
    and VecNest (which came with distribution) on one rank equal the
    reference's (four ranks: tests/test_torch_dist_sf.py)."""
    for name in ("DMSwarm", "DMNetwork", "IS", "DMStag", "DMComposite", "Regressor", "AO",
                 "Random", "viewer", "KSP", "DMDA", "DMPlex", "MatColoring"):
        assert getattr(ptt, name).__module__.startswith("petsc_tpu_torch") \
            if not isinstance(getattr(ptt, name), type(np)) else True, name
        assert hasattr(pt_jax, name)
    ptt.init(device="cpu")
    x = np.arange(10.0)
    g, rg = ptt.VecGhost.createGhost(10, [7, 2]), pt_jax.VecGhost.createGhost(10, [7, 2])
    g.setArray(x)
    rg.setArray(x)
    g.ghostUpdate()
    rg.ghostUpdate()
    assert np.array_equal(g.getLocalForm().numpy(), np.asarray(rg.getLocalForm()))
    g.setLocalForm(np.arange(12.0))
    rg.setLocalForm(np.arange(12.0))
    g.ghostUpdate(ptt.InsertMode.ADD_VALUES, "reverse")
    rg.ghostUpdate(pt_jax.InsertMode.ADD_VALUES, "reverse")
    assert np.array_equal(g.getArray(), np.asarray(rg.getArray()))
    nv = ptt.VecNest.create([ptt.Vec.from_array(x[:4]), ptt.Vec.from_array(x[4:])])
    rn = pt_jax.VecNest.create([pt_jax.Vec.from_array(x[:4]), pt_jax.Vec.from_array(x[4:])])
    assert nv.getNestSize() == rn.getNestSize() == 2
    assert np.array_equal(nv.getArray(), np.asarray(rn.getArray()))


def test_index_sets_equal_the_reference():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 40, 25), rng.integers(0, 40, 30)
    pairs = [(IS.createGeneral(a), RIS.createGeneral(a)),
             (IS.createStride(7, 3, 2), RIS.createStride(7, 3, 2)),
             (IS.createBlock(3, [4, 0, 2]), RIS.createBlock(3, [4, 0, 2]))]
    for p, r in pairs:
        assert np.array_equal(p.getIndices(), r.getIndices())
        assert (p.getSize(), p.getLocalSize(), p.getBlockSize(), len(p)) == \
            (r.getSize(), r.getLocalSize(), r.getBlockSize(), len(r))
        for op in ("sort", "invertPermutation" if p.getSize() and np.array_equal(
                np.sort(p.getIndices()), np.arange(p.getSize())) else "duplicate"):
            assert np.array_equal(getattr(p, op)().getIndices(), getattr(r, op)().getIndices())
        for op in ("difference", "union", "intersect"):
            assert np.array_equal(getattr(p, op)(b).getIndices(), getattr(r, op)(b).getIndices())
        assert np.array_equal(p.complement(0, 45).getIndices(), r.complement(0, 45).getIndices())
        assert p.isSorted() == r.isSorted() and p.equal(r.getIndices())
        assert np.array_equal(np.asarray(p), np.asarray(r)) and np.asarray(p, np.int32).dtype == np.int32
    perm = rng.permutation(12)
    assert np.array_equal(IS(perm).invertPermutation().getIndices(),
                          RIS(perm).invertPermutation().getIndices())


def test_lgmap_and_ao_equal_the_reference():
    g = np.array([5, 3, 9, 3, 1, 12])
    q = [3, 9, 7, 1, 5, 0, 12, -2]
    assert np.array_equal(LGMap(g).apply([0, 2, 5]), RLGMap(g).apply([0, 2, 5]))
    assert np.array_equal(LGMap(g).applyInverse(q), RLGMap(g).applyInverse(q))
    assert np.array_equal(LGMap([]).applyInverse([1, 2]), [-1, -1]) and LGMap(g).getSize() == 6
    app = np.random.default_rng(2).permutation(50)
    petsc = np.random.default_rng(3).permutation(50)
    for args in ((app,), (app, petsc)):
        p, r = AO.createBasic(*args), RAO.createBasic(*args)
        idx = np.array([0, 7, -1, 49, 13])
        assert np.array_equal(p.applicationToPetsc(idx), r.applicationToPetsc(idx))
        assert np.array_equal(p.petscToApplication(idx), r.petscToApplication(idx))
        assert p.applicationToPetsc(-1) == -1 and p.petscToApplication(3) == r.petscToApplication(3)
