"""petsc_tpu_torch's DMDA, KSP.setDM and PCMG from a DM against petsc_tpu,
on the CPU, case by case after tests/test_dmda.py: the DMDA basics
(vectors, indices, coordinates, masks, offsets, the stencil pattern,
injection, -da_grid_x|y|z and -da_refine), coarsen and refine, the
interpolation (partition of unity; the Q1 transfers at dof 2 in 2-D and
dof 3 in 3-D; the assembled P of a grid that is not factor 2 or is
periodic), PETSc's ex45 at 17^3 under -pc_type mg and gamg, the dof-3
PCMG from the DM with Galerkin coarse operators, the KSP's DM callbacks,
and tests/test_mg_gamg.py's cycle types (w, full, kaskade) and fourth-kind
Chebyshev smoothers on PCMG from a DM.

Tolerances: the transfers to 1e-12 relative; solves with equal iterations
and reasons, histories to 1e-6 relative and solutions to 1e-10 relative
(the same algorithm; the card's and XLA's sums differ in order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from examples import ex45 as ex45_jax
from petsc_tpu.ops import operator as op_jax
from petsc_tpu_torch.examples import ex45
from petsc_tpu_torch.ops import operator
from petsc_tpu_torch.sys.error import Error

torch.set_num_threads(1)

GRID17 = ["-da_grid_x", "17", "-da_grid_y", "17", "-da_grid_z", "17"]
EX45_ARGS = GRID17 + ["-ksp_type", "cg", "-ksp_rtol", "1e-8"]


def _init(pkg, args=()):
    if pkg is ptt:
        ptt.init(args=list(args), device="cpu")
    else:
        pt_jax.init(args=list(args))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _both(fn):
    """fn(pkg) for the reference and then the port."""
    out = []
    for pkg in (pt_jax, ptt):
        _init(pkg)
        out.append(fn(pkg))
    return out


# ------------------------------------------------------------ the basics

def test_da_basic():
    def run(pkg):
        da = pkg.DMDA.create(2, (9, 5), dof=2)
        v = da.createGlobalVector()
        arr = da.getVecArray(v)
        arr[2, 3, 1] = 7.0
        da.setVecArray(v, arr)
        return da.N, arr.shape, np.asarray(v.getArray()), da.dof_index(3, 2, c=1), v._dm is da

    ref, port = _both(run)
    assert port[0] == ref[0] == 90 and port[1] == ref[1] == (5, 9, 2)
    assert np.array_equal(port[2], ref[2]) and port[2][port[3]] == 7.0 and port[4]


@pytest.mark.parametrize("dim,sizes,stype,width", [
    (1, (7,), "star", 1), (2, (5, 4), "box", 1), (2, (6, 5), "star", 2),
    (3, (4, 3, 5), "star", 1), (3, (3, 4, 3), "box", 1)])
def test_da_geometry(dim, sizes, stype, width):
    def run(pkg):
        da = pkg.DMDA.create(dim, sizes, dof=1, stencil_width=width, stencil_type=stype)
        return (da.node_coords(), da.interior_mask(), da.interior_mask(width=2),
                da.stencil_offsets(), da.getInfo(), da.getCorners(), da.getGhostCorners())

    ref, port = _both(run)
    for a, b in zip(port[:3], ref[:3]):
        assert np.array_equal(a, b)
    assert port[3:] == ref[3:]


@pytest.mark.parametrize("dof,stype,boundary", [
    (1, "star", None), (1, "box", None), (2, "star", None), (1, "star", "periodic")])
def test_da_stencil_pattern(dof, stype, boundary):
    def run(pkg):
        da = pkg.DMDA.create(2, (5, 4), dof=dof, stencil_type=stype, boundary_type=boundary)
        A = da.createMatrix(preallocate_pattern=True)
        return A.to_scipy(), A.getSize()

    ref, port = _both(run)
    assert port[1] == ref[1]
    assert (port[0] != ref[0]).nnz == 0 and (port[0] != 0).nnz == 0


def test_da_vectors_and_injection():
    def run(pkg):
        da = pkg.DMDA.create(3, (9, 5, 7))
        dac = da.coarsen()
        g = da.createGlobalVector()
        g.setArray(np.arange(da.N, dtype=np.float64))
        loc = da.createLocalVector()
        da.globalToLocal(g, loc)
        back = da.createGlobalVector()
        da.localToGlobal(loc, back)
        inj = da.createInjection(dac)
        return (np.asarray(loc.getArray()), np.asarray(back.getArray()),
                np.asarray(inj(g.array)), inj.np(np.asarray(g.getArray())))

    ref, port = _both(run)
    for a, b in zip(port, ref):
        assert np.array_equal(a, b)


def test_da_set_from_options():
    def run(pkg):
        out = []
        for args in (["-da_grid_x", "11", "-da_grid_y", "6"], ["-da_refine", "2"]):
            _init(pkg, args)
            da = pkg.DMDA.create(2, (5, 4))
            da.setFromOptions()
            out.append(da.sizes)
        return out

    ref, port = _both(run)
    assert port == ref == [(11, 6), (17, 13)]


def test_da_view(capsys):
    for pkg in (pt_jax, ptt):
        _init(pkg)
        pkg.DMDA.create(3, (9, 5, 7), dof=2).view()
    ref, port = capsys.readouterr().out.strip().splitlines()
    assert port == ref


def test_da_coarsen_refine():
    def run(pkg):
        da = pkg.DMDA.create(3, (9, 9, 9))
        dac = da.coarsen()
        per = pkg.DMDA.create(2, (8, 9), boundary_type=("periodic", "none"))
        bad = pkg.DMDA.create(2, (8, 9))
        with pytest.raises(Exception, match="cannot coarsen"):
            bad.coarsen()
        return dac.sizes, dac.refine().sizes, per.coarsen().sizes, per.refine().sizes

    ref, port = _both(run)
    assert port == ref and port[:2] == ((5, 5, 5), (9, 9, 9))


@pytest.mark.parametrize("shape", [(5, 7), (9, 3, 4), (17, 17, 17), (3, 3, 3, 3)])
def test_grid_offsets_key_sort_equals_row_sort(shape):
    """MatAIJ's grid offsets by one int64 key per entry give np.unique's
    rows over the (nnz, ndim) offsets, in its order, with its inverse."""
    from petsc_tpu_torch.mat.aij import _unique_offsets
    rng = np.random.default_rng(len(shape))
    d = np.stack([rng.integers(-s + 1, s, 4000) for s in shape], axis=1)
    uniq, inv = np.unique(d, axis=0, return_inverse=True)
    got_u, got_i = _unique_offsets(d, shape)
    assert np.array_equal(got_u, uniq) and np.array_equal(got_i, inv.reshape(-1))


# ------------------------------------------------------------ interpolation

def test_da_interpolation_partition_of_unity():
    def run(pkg):
        da = pkg.DMDA.create(2, (9, 9))
        dac = da.coarsen()
        P = da.createInterpolation(dac)
        ones = pkg.Vec.from_array(np.ones(dac.N))
        y = P.createVecLeft()
        P.mult(ones, y)
        return np.asarray(y.getArray()), P.meta[0]

    ref, port = _both(run)
    assert port[1] == ref[1] == "interp_q1"
    assert np.array_equal(port[0], ref[0]) and np.allclose(port[0], 1.0)


@pytest.mark.parametrize("dim,fine,coarse,dof", [
    (2, (9, 9), (5, 5), 2), (3, (9, 5, 7), (5, 3, 4), 3), (2, (8, 9), (4, 5), 1)])
def test_interp_dof2(dim, fine, coarse, dof):
    """The Q1 interpolation with dof > 1 interpolates each component (the
    dainterp.c dof-block path): the port's P and its transfers equal the
    reference's to 1e-12, at dof 2 in 2-D and dof 3 in 3-D; a grid that is
    not factor 2 (8 -> 4) takes the assembled P in both."""
    rng = np.random.default_rng(1)
    Ps, ys = [], []
    bnd = ("periodic", "none") if fine == (8, 9) else None
    for pkg in (pt_jax, ptt):
        _init(pkg)
        dac = pkg.DMDA.create(dim=dim, sizes=coarse, dof=dof, boundary_type=bnd)
        daf = pkg.DMDA.create(dim=dim, sizes=fine, dof=dof, boundary_type=bnd)
        P = daf.createInterpolation(dac)
        Ps.append((P.to_scipy(), P.meta[0]))
        xc = rng.random(dac.N) if not ys else ys[0][2]
        xf = rng.random(daf.N) if not ys else ys[0][3]
        if pkg is ptt:
            op = operator.bind(P.meta, P.device_data())
            y, yt = op.mult(torch.from_numpy(xc)), op.mult_t(torch.from_numpy(xf))
        else:
            op = op_jax.bind(P.meta, P.device_data())
            y, yt = op.mult(jnp.asarray(xc)), op.mult_t(jnp.asarray(xf))
        ys.append((np.asarray(y)[: daf.N], np.asarray(yt)[: dac.N], xc, xf))
    (Pj, kj), (Pp, kp) = Ps
    assert Pp.shape == (int(np.prod(fine)) * dof, int(np.prod(coarse)) * dof)
    assert kp == ("aij_csr" if fine == (8, 9) else "interp_q1")
    assert _rel(Pp.toarray(), Pj.toarray()) <= 1e-12
    (yj, ytj, xc, xf), (yp, ytp, _, _) = ys
    assert _rel(yp, yj) <= 1e-12 and _rel(ytp, ytj) <= 1e-12
    assert _rel(yp, Pp @ xc) <= 1e-12 and _rel(ytp, Pp.T @ xf) <= 1e-12


# ------------------------------------------------------------ ex45 and PCMG from a DM

def _ex45(pkg, args):
    if pkg is ptt:
        return ex45.main(list(args), device="cpu")
    return ex45_jax.main(list(args))


def _solution(ksp):
    return np.asarray(ksp.getSolution().getArray())[: ksp.mat.getSize()[0]]


def _hold(ksp_p, ksp_j):
    assert ksp_p.getIterationNumber() == ksp_j.getIterationNumber()
    assert ksp_p.getConvergedReason().name == ksp_j.getConvergedReason().name
    hp, hj = ksp_p.getConvergenceHistory(), ksp_j.getConvergenceHistory()
    assert hp.shape == hj.shape and float(np.max(np.abs(hp - hj) / hj)) <= 1e-6
    assert _rel(_solution(ksp_p), _solution(ksp_j)) <= 1e-10


@pytest.mark.parametrize("pc,its", [("mg", 8), ("gamg", 7)])
def test_ex45(pc, its):
    """ex45 at 17^3 under CG: PCMG from the DM (4 rediscretized levels, all
    aij_dnd) takes the reference's 8 iterations, GAMG's structured head 7;
    the same histories, solutions and hierarchy."""
    ksp_j = _ex45(pt_jax, EX45_ARGS + ["-pc_type", pc])
    ksp_p = _ex45(ptt, EX45_ARGS + ["-pc_type", pc])
    assert ksp_p.getIterationNumber() == its and ksp_p.getConvergedReason().name == "CONVERGED_RTOL"
    _hold(ksp_p, ksp_j)
    lp, lj = ksp_p.getPC()._impl.levels, ksp_j.getPC()._impl.levels
    assert [lev.A.getSize()[0] for lev in lp] == [lev.A.getSize()[0] for lev in lj]
    assert ksp_p.mat.meta[0] == "aij_dnd"
    if pc == "mg":
        assert [lev.A.meta[0] for lev in lp] == ["aij_dnd"] * 4
        assert [lev.P.meta[0] for lev in lp[:-1]] == ["interp_q1"] * 3
        for a, b in zip(lp[:-1], lj[:-1]):
            assert abs(a.emax - b.emax) <= 1e-12 * b.emax
    # the true residual, as ex45 prints it
    r = ksp_p.mat.createVecLeft()
    ksp_p.mat.mult(ksp_p.getSolution(), r)
    b = ksp_p.getDM().createGlobalVector()
    ex45.compute_rhs(ksp_p, b)
    r.axpy(-1.0, b)
    assert float(r.norm()) < 1e-8 * max(float(b.norm()), 1)


def test_ex45_output():
    """ex45's printed lines, against the reference's run."""
    from petsc_tpu.utils.testing import run_example as run_jax
    from petsc_tpu_torch.utils.testing import assert_output, run_example
    args = ["-da_grid_x", "9", "-da_grid_y", "9", "-da_grid_z", "9", "-ksp_type", "cg",
            "-pc_type", "mg", "-ksp_monitor_short", "-ksp_rtol", "1e-8"]
    want = run_jax(ex45_jax.main, args)
    got = run_example(ex45.main, args, device="cpu")
    assert want.splitlines()[-1] == got.splitlines()[-1] == "iterations 8"
    assert_output(got, want, rtol=1e-6, atol=1e-12)


def test_pcmg_dof3_galerkin():
    """dof 3 (the 7-point operator per component): PCMG from the DM with no
    callback takes Galerkin coarse operators through kron(P, I_3); the
    port's level 0 is aij_bsr (B1), its transfers Q1P/Q1R at dof 3."""
    out = []
    for pkg, ex in ((pt_jax, ex45_jax), (ptt, ex45)):
        _init(pkg, ["-ksp_type", "cg", "-pc_type", "mg", "-ksp_rtol", "1e-8"])
        da = pkg.DMDA.create(3, (9, 9, 9), dof=3)
        A = da.createMatrix()
        i, j, v = ex45.component_laplacian(da)
        A.setPreallocationCOO(i, j)
        A.setValuesCOO(v)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        b = A.createVecLeft()
        b.set(1.0)
        ksp.solve(b)
        out.append(ksp)
    ksp_j, ksp_p = out
    assert ksp_p.mat.meta[0] == "aij_bsr"
    lp = ksp_p.getPC()._impl.levels
    assert [lev.A.getSize()[0] for lev in lp] == [2187, 375, 81, 24]
    assert [lev.P.meta for lev in lp[:-1]][0] == ("interp_q1", (9, 9, 9), (5, 5, 5), 3)
    assert [lev.A.getSize()[0] for lev in ksp_j.getPC()._impl.levels] == [2187, 375, 81, 24]
    _hold(ksp_p, ksp_j)


def test_pcmg_levels_option_and_callback_ksp():
    """-pc_mg_levels caps the hierarchy; the rediscretizing callback gets
    ksp None on the coarse levels (the reference's mg.py:292) and the KSP on
    the fine one; the initial-guess callback makes the guess nonzero."""
    seen = {}
    for pkg, ex in ((pt_jax, ex45_jax), (ptt, ex45)):
        _init(pkg, ["-ksp_type", "cg", "-pc_type", "mg", "-pc_mg_levels", "2",
                    "-ksp_rtol", "1e-8"])
        calls = []

        def ops(ksp, A, B, ex=ex, calls=calls):
            calls.append(ksp is None)
            ex.compute_operators(ksp, A, B)

        def guess(ksp, x):
            x.set(0.5)

        da = pkg.DMDA.create(3, (9, 9, 9))
        ksp = pkg.KSP().create()
        ksp.setDM(da)
        ksp.setComputeOperators(ops)
        ksp.setComputeRHS(ex.compute_rhs)
        ksp.setComputeInitialGuess(guess)
        ksp.setFromOptions()
        ksp.solve()
        seen[pkg.__name__] = (calls, ksp.guess_nonzero, ksp.getIterationNumber(),
                              [lev.A.getSize()[0] for lev in ksp.getPC()._impl.levels],
                              ksp.getConvergenceHistory())
    (cj, gj, ij, lj, hj), (cp, gp, ip, lp, hp) = seen.values()
    assert cp == cj == [False, True] and gp and gj
    assert ip == ij and lp == lj == [729, 125]
    assert float(np.max(np.abs(hp - hj) / hj)) <= 1e-6


def test_pcmg_from_dm_refusals():
    _init(ptt, ["-ksp_type", "cg", "-pc_type", "mg"])
    ksp = ptt.KSP().create()
    with pytest.raises(AttributeError):
        ksp.setComputeOperators(ex45.compute_operators)   # no DM attached
    A = ptt.MatAIJ.from_scipy(__import__("scipy.sparse").sparse.eye(8, format="csr"))
    A._dm = ptt.DM()
    ksp.setOperators(A)
    ksp.setFromOptions()
    with pytest.raises(Error, match="not a DMDA"):
        ksp.setUp()


# ------------------------------------------------------------ cycles and smoothers

@pytest.mark.parametrize("mgtype,ktype", [("w", "cg"), ("full", "cg"), ("kaskade", "gmres")])
def test_mg_cycle_types(mgtype, ktype):
    """tests/test_mg_gamg.py::test_mg_cycle_types on the port: W, FULL and
    KASKADE cycles of PCMG from ex45's DM at 17^3, the reference's
    iterations and history."""
    args = EX45_ARGS + ["-ksp_type", ktype, "-pc_type", "mg", "-ksp_max_it", "200"]
    args += ["-pc_mg_cycle_type", "w"] if mgtype == "w" else ["-pc_mg_type", mgtype]
    ksp_j = _ex45(pt_jax, args)
    ksp_p = _ex45(ptt, args)
    assert ksp_p.getConvergedReason().converged
    _hold(ksp_p, ksp_j)


@pytest.mark.parametrize("kind", ["fourth", "opt_fourth"])
def test_mg_fourth_kind_chebyshev_smoother(kind):
    """tests/test_mg_gamg.py::test_mg_fourth_kind_chebyshev_smoother on the
    port: the 2-D 5-point Poisson operator on a 33 x 33 DMDA, PCMG from the
    DM with the fourth-kind smoother and with the first kind, the
    reference's iterations and histories."""
    import scipy.sparse as sp
    n = 33
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
    A_sp = (sp.kron(sp.eye(n), T) + sp.kron(T, sp.eye(n))).tocsr()
    its = {}
    for pkg in (pt_jax, ptt):
        _init(pkg)
        A = pkg.MatAIJ.from_scipy(A_sp)
        A._dm = pkg.DMDA.create(dim=2, sizes=(n, n))
        for smoother in (kind, "chebyshev"):
            ksp = pkg.KSP().create()
            ksp.setOperators(A)
            ksp.setType("cg")
            pc = ksp.getPC()
            pc.setType("mg")
            pc._impl.smoother = smoother
            ksp.setTolerances(rtol=1e-8)
            b = pkg.Vec.from_array(np.ones(A_sp.shape[0]))
            x = A.createVecRight()
            ksp.solve(b, x)
            assert ksp.getConvergedReason().converged
            r = A_sp @ np.asarray(x.getArray())[: A_sp.shape[0]] - 1.0
            assert np.linalg.norm(r) < 1e-6 * np.sqrt(A_sp.shape[0])
            its[(pkg.__name__, smoother)] = (ksp.getIterationNumber(),
                                             ksp.getConvergenceHistory())
    for smoother in (kind, "chebyshev"):
        (ij, hj), (ip, hp) = its[("petsc_tpu", smoother)], its[("petsc_tpu_torch", smoother)]
        assert ip == ij and float(np.max(np.abs(hp - hj) / hj)) <= 1e-6
    assert its[("petsc_tpu_torch", kind)][0] <= its[("petsc_tpu_torch", "chebyshev")][0] + 4
