"""petsc_tpu_torch's DMComposite, DMShell, DMRedundant, DMStag and the MAC
Stokes example against petsc_tpu, on the CPU, after tests/test_dm_more.py.

Tolerances: layouts, offsets and vector values equal; the Stokes CSR and
right-hand side equal bit for bit; solves with equal iterations and
reasons, histories to 1e-6 relative, u_err to 1e-10 relative (FGMRES on
the same system; the two packages sum in other orders)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.dm import DMComposite as RComposite, DMRedundant as RRedundant, DMShell as RShell
from petsc_tpu.dm import DMStag as RStag
from petsc_tpu_torch.dm import DMComposite, DMRedundant, DMShell, DMStag
from petsc_tpu_torch.examples import stokes_stag

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "ref_stokes_stag", Path(__file__).resolve().parent.parent / "examples" / "stokes_stag.py")
ref_stokes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_stokes)


def _init():
    pt_jax.init(args=[])
    ptt.init(args=[], device="cpu")


def _composite(pkg, Composite, Redundant, n=5, nred=3):
    da = pkg.DMDA.create(2, (n, n))
    return Composite.create([da, Redundant.create(nred)])


def test_composite_pack_unpack():
    _init()
    got = []
    for pkg, C, R in ((pt_jax, RComposite, RRedundant), (ptt, DMComposite, DMRedundant)):
        dmc = _composite(pkg, C, R)
        assert dmc.N == 28 and dmc.getNumberDM() == 2
        v = dmc.createGlobalVector()
        subs = dmc.getAccess(v)
        subs[0].set(1.0)
        subs[1].setArray(np.array([7.0, 8.0, 9.0]))
        dmc.restoreAccess(v, subs)
        iss = dmc.getFieldIS()
        got.append((np.asarray(v.getArray()), [np.asarray(s) for s in iss],
                    dmc.createMatrix().getSize()))
    (a, ia, sa), (b, ib, sb) = got
    assert np.array_equal(a, b) and np.allclose(b[:25], 1.0) and np.array_equal(b[25:], [7, 8, 9])
    assert all(np.array_equal(x, y) for x, y in zip(ia, ib)) and sa == sb == (28, 28)


def test_composite_fieldsplit_on_is():
    """The composite's field ISes drive PCFieldSplit.setIS (an IS, as the
    reference's takes): the same its, history and solution."""
    _init()
    from tests.test_mg_gamg import poisson2d
    A = sp.block_diag([poisson2d(6) + sp.eye(36), sp.eye(4, format="csr") * 3.0]).tocsr()
    out = []
    for pkg, C, R in ((pt_jax, RComposite, RRedundant), (ptt, DMComposite, DMRedundant)):
        dmc = _composite(pkg, C, R, n=6, nred=4)
        M = pkg.MatAIJ.from_scipy(A)
        ksp = pkg.KSP().create()
        ksp.setOperators(M)
        ksp.setType("gmres")
        pc = ksp.getPC()
        pc.setType("fieldsplit")
        for k, iset in enumerate(dmc.getFieldIS()):
            pc._impl.setIS(str(k), iset)
        ksp.setTolerances(rtol=1e-10)
        b = M.createVecLeft()
        b.set(1.0)
        x = M.createVecRight()
        ksp.solve(b, x)
        out.append((ksp.getIterationNumber(), int(ksp.getConvergedReason()),
                    np.asarray(ksp.getConvergenceHistory()), np.asarray(x.getArray())[:40]))
    (ia, ra, ha, xa), (ib, rb, hb, xb) = out
    assert isinstance(DMComposite.create([]).getFieldIS(), list)
    assert (ia, ra) == (ib, rb) and rb > 0
    assert np.max(np.abs(ha - hb) / np.abs(ha)) <= 1e-6
    assert np.max(np.abs(xa - xb)) <= 1e-10 * np.max(np.abs(xa))


def test_shell_and_redundant():
    _init()
    for pkg, Shell, Red in ((pt_jax, RShell, RRedundant), (ptt, DMShell, DMRedundant)):
        dm = Shell()
        with pytest.raises(pkg.Error):
            dm.createGlobalVector()
        dm.setCreateGlobalVector(lambda d, pkg=pkg: pkg.Vec.from_array(np.zeros(7)))
        dm.setCreateMatrix(lambda d, pkg=pkg: pkg.MatAIJ.from_scipy(sp.eye(7, format="csr")))
        v = dm.createGlobalVector()
        assert v.getSize() == 7 and v._dm is dm and dm.createMatrix()._dm is dm
        red = Red.create(4)
        assert red.N == 4 and red.createGlobalVector().getSize() == 4
        assert red.createMatrix().getSize() == (4, 4)
    assert DMRedundant.create(4).createGlobalVector().array.device.type == "cpu"


STAG_CASES = [(8, (1, 1)), (5, (0, 2)), ((4, 3), (1, 1, 2)), ((4, 3), (0, 1, 1)),
              ((3, 5), (2, 0, 1)), ((2, 3, 4), (1, 1, 1, 1)), ((2, 3, 4), (0, 2, 0, 1)),
              ((3, 2, 2), (1, 0, 3, 2))]


@pytest.mark.parametrize("sizes,dof", STAG_CASES)
def test_stag_layout_arrays_and_split(sizes, dof):
    """The stratum order, shapes, dofs and offsets equal the reference's;
    setVecArray / getVecArray / splitToDMDA move the same values."""
    _init()
    r, p = RStag.create(sizes, dof), DMStag.create(sizes, dof)
    assert p._stratum_shapes() == r._stratum_shapes()
    assert p.getStratumOffsets() == r.getStratumOffsets() and p.N == r.N
    rv, pv = r.createGlobalVector(), p.createGlobalVector()
    rng = np.random.default_rng(3)
    for name, (off, sh, nd) in p.getStratumOffsets().items():
        vals = rng.standard_normal(int(np.prod(sh)) * nd)
        r.setVecArray(rv, name, vals)
        p.setVecArray(pv, name, vals)
    assert np.array_equal(np.asarray(rv.getArray()), pv.getArray())
    for name in p.getStratumOffsets():
        a, b = r.getVecArray(rv, name), p.getVecArray(pv, name)
        assert a.shape == b.shape and np.array_equal(a, b)
        (rda, rdv), (pda, pdv) = r.splitToDMDA(rv, name), p.splitToDMDA(pv, name)
        assert pda.sizes == rda.sizes and pda.dof == rda.dof
        assert np.array_equal(np.asarray(rdv.getArray()), pdv.getArray())
    assert p.createMatrix().getSize() == (p.N, p.N)


def test_stag_rejects_a_wrong_dof_count():
    with pytest.raises(ptt.Error):
        DMStag.create((4, 4), (1, 1))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 16, 33])
def test_stokes_assembly_is_the_references_csr_in_bits(n):
    _, Ar, br, offr = ref_stokes.assemble(n)
    st, Ap, bp, offp = stokes_stag.assemble(n)
    assert offr == offp and Ap.shape == Ar.shape == (st.N, st.N)
    assert np.array_equal(Ar.indptr, Ap.indptr) and np.array_equal(Ar.indices, Ap.indices)
    assert np.array_equal(Ar.data.view(np.int64), Ap.data.view(np.int64))
    assert np.array_equal(br.view(np.int64), bp.view(np.int64))


@pytest.mark.parametrize("n", [8, 16])
def test_stokes_mac_fieldsplit_solve(n):
    """FGMRES + fieldsplit Schur (full, selfp; ILU(0) and Jacobi blocks):
    the reference's iterations, reason, history and errors."""
    kr, er, dr = ref_stokes.main(["-n", str(n)])
    kp, ep, dp = stokes_stag.main(["-n", str(n)], device="cpu")
    assert (kp.getIterationNumber(), int(kp.getConvergedReason())) == \
        (kr.getIterationNumber(), int(kr.getConvergedReason()))
    assert kp.getConvergedReason().converged
    hr, hp = np.asarray(kr.getConvergenceHistory()), np.asarray(kp.getConvergenceHistory())
    assert len(hr) == len(hp) and np.max(np.abs(hp - hr) / np.abs(hr)) <= 1e-6
    assert abs(ep - er) <= 1e-10 * er
    assert dp < 1e-8 and abs(dp - dr) <= 1e-9
