"""PCGAMG's structured head in petsc_tpu_torch against petsc_tpu's, on the
CPU: the device Galerkin product by stencil probing and its download
(pc/gamg_device.py), the Lanczos bounds, the host head on a MatAIJ that
declares a grid, the Amat/Pmat split, and CG+GAMG solves on the stencil
operator of bench.py's solve (build_dnd + as_mat) at 16^3 and 32^3, box
and star, f64 and f32 cycles. Every test of tests/test_gamg_device.py
and the structured-head tests of tests/test_gamg_structured.py run here
against the reference's own function on the same input.

Tolerances: probed planes to 1e-12 (absolute, against the host
Galerkin product, as the reference's test) and 1e-12 relative against the
reference's planes; Lanczos bounds to 1e-10 relative in float64 (the dot
products and norms sum in another order); solver histories to 1e-6
relative with equal iterations, reasons and hierarchies (the float32
cycle, whose head is probed in float32, to 1e-4)."""

from itertools import product

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.ops import stencil_build as sb_jax
from petsc_tpu.pc import gamg_device as gd_jax
from petsc_tpu_torch.dm.interp import MatInterpQ1
from petsc_tpu_torch.ops import stencil_build
from petsc_tpu_torch.pc import gamg_device as gd

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _random_stencil(shape, seed=0):
    """tests/test_gamg_device.py's variable-coefficient {-1,0,1}^d stencil."""
    rng = np.random.default_rng(seed)
    nd, N = len(shape), int(np.prod(shape))
    idx = np.indices(shape).reshape(nd, -1)
    strides = np.array([int(np.prod(shape[d + 1:])) for d in range(nd)])
    rows_l, cols_l, vals_l = [], [], []
    for o in product((-1, 0, 1), repeat=nd):
        tgt = idx + np.asarray(o)[:, None]
        ok = np.ones(N, bool)
        for d in range(nd):
            ok &= (tgt[d] >= 0) & (tgt[d] < shape[d])
        v = rng.standard_normal(N) + (6.0 if not any(o) else 0.0)
        rows_l.append(np.nonzero(ok)[0])
        cols_l.append((strides @ tgt)[ok])
        vals_l.append(v[ok])
    return sp.csr_matrix((np.concatenate(vals_l),
                          (np.concatenate(rows_l), np.concatenate(cols_l))), shape=(N, N))


def poisson3d(n, pts=7):
    """tests/test_gamg_structured.py's 7- and 27-point operators."""
    ex = np.ones(n)
    T1 = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1], format="csr")
    I1 = sp.identity(n, format="csr")
    if pts == 7:
        return (sp.kron(sp.kron(T1, I1), I1) + sp.kron(sp.kron(I1, T1), I1)
                + sp.kron(sp.kron(I1, I1), T1)).tocsr()
    B1 = sp.diags([ex[:-1], 4 * ex, ex[:-1]], [-1, 0, 1], format="csr")
    return (sp.kron(sp.kron(T1, B1), B1) + sp.kron(sp.kron(B1, T1), B1)
            + sp.kron(sp.kron(B1, B1), T1)).tocsr()


def _grid_mats(A_sp, shape):
    pt_jax.init()
    ptt.init(device="cpu")
    Aj = pt_jax.MatAIJ.from_scipy(A_sp)
    Aj.setStencilGrid(shape)
    A = ptt.MatAIJ.from_scipy(A_sp)
    A.setStencilGrid(shape)
    return Aj, A


# ------------------------------------------------------------------ the probe

@pytest.mark.parametrize("shape", [(9, 8, 7), (8, 8), (7, 7), (6, 9)])
def test_device_rap_matches_host_galerkin(shape):
    A_sp = _random_stencil(shape)
    Aj, A = _grid_mats(A_sp, shape)
    assert A.meta[0] == "aij_dnd"
    # dnd -> CSR download round-trips the fine operator
    assert abs(A_sp - gd.dnd_to_csr(A.meta, A.device_data())).max() < 1e-13
    cshape = tuple((s + 1) // 2 for s in shape)
    cmeta, cdata = gd.device_rap_dnd(A.meta, A.device_data(), cshape)
    cmeta_j, cdata_j = gd_jax.device_rap_dnd(Aj.meta, Aj.device_data(), cshape)
    assert cmeta == cmeta_j
    assert _rel(cdata["coef"].numpy(), np.asarray(cdata_j["coef"])) <= 1e-12
    assert _rel(cdata["diag"].numpy(), np.asarray(cdata_j["diag"])) <= 1e-12
    Ac = gd.dnd_to_csr(cmeta, cdata)
    P = MatInterpQ1(shape, cshape).to_scipy()
    assert abs(Ac - (P.T @ A_sp @ P).tocsr()).max() < 1e-12


def test_device_rap_const_stencil():
    """The constant-folded dnd meta (build_dnd) probes as its CSR twin."""
    shape = (10, 10, 10)
    ptt.init(device="cpu")
    meta, data = stencil_build.build_dnd(shape, kind="star")
    A = gd.dnd_to_csr(meta, data)
    cshape = tuple((s + 1) // 2 for s in shape)
    cmeta, cdata = gd.device_rap_dnd(meta, data, cshape)
    P = MatInterpQ1(shape, cshape).to_scipy()
    assert abs(gd.dnd_to_csr(cmeta, cdata) - (P.T @ A @ P).tocsr()).max() < 1e-12
    mj, dj = sb_jax.build_dnd(shape, kind="star")
    _, cdata_j = gd_jax.device_rap_dnd(mj, dj, cshape)
    assert _rel(cdata["coef"].numpy(), np.asarray(cdata_j["coef"])) <= 1e-12


def test_device_emax_tracks_spectrum():
    n = 12
    T = sp.diags([-1, 2.2, -1], [-1, 0, 1], (n, n))
    A_sp = (sp.kron(T, sp.eye(n)) + sp.kron(sp.eye(n), T)).tocsr()
    Aj, A = _grid_mats(A_sp, (n, n))
    em = gd.device_emax(A.meta, A.device_data())
    assert abs(em - gd_jax.device_emax(Aj.meta, Aj.device_data())) <= 1e-10 * em
    ref = np.max(np.abs(np.linalg.eigvals(np.diag(1.0 / A_sp.diagonal()) @ A_sp.toarray())))
    assert abs(em - ref) / ref < 0.06


@pytest.mark.parametrize("kind", ("box", "star"))
def test_device_emax_folds_a_constant_diagonal(kind):
    """The constant-diagonal stencil's similarity scaling folded to scalars,
    in both dtypes, against the reference's (the start vector is JAX's
    threefry with key 7)."""
    ptt.init(device="cpu")
    meta, data = stencil_build.build_dnd((12, 11, 10), kind=kind)
    mj, dj = sb_jax.build_dnd((12, 11, 10), kind=kind)
    em, emj = gd.device_emax(meta, data), gd_jax.device_emax(mj, dj)
    assert abs(em - emj) <= 1e-10 * emj
    em32 = gd.device_emax(meta, data, dtype=torch.float32)
    assert abs(em32 - gd_jax.device_emax(mj, dj, dtype=jnp.float32)) <= 1e-4 * emj


# ------------------------------------------------------------------ solves

def _solve(pkg, A, args, P=None, tol=(1e-8, 60)):
    ksp = pkg.KSP().create()
    ksp.setOperators(A, P)
    ksp.setType("cg")
    ksp.getPC().setType("gamg")
    ksp.getPC().setFromOptions()
    ksp.setTolerances(rtol=tol[0], max_it=tol[1])
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp, x


def _both(A_sp, shape, args=(), grid=True):
    """CG+GAMG on A_sp (a MatAIJ, on `shape` when grid) in both packages:
    (reference KSP, port KSP, port solution)."""
    out = []
    for pkg in (pt_jax, ptt):
        if pkg is ptt:
            ptt.init(args=list(args), device="cpu")
        else:
            pt_jax.init(args=list(args))
        A = pkg.MatAIJ.from_scipy(A_sp)
        if grid:
            A.setStencilGrid(shape)
        out.append(_solve(pkg, A, args))
    return out[0][0], out[1][0], np.asarray(out[1][1].getArray())


def _same_run(kj, kp, rtol=1e-6):
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    np.testing.assert_allclose(kp.getConvergenceHistory(), kj.getConvergenceHistory(),
                               rtol=rtol, atol=0)
    lj, lp = kj.getPC()._impl.levels, kp.getPC()._impl.levels
    assert [l.A.getSize()[0] for l in lp] == [l.A.getSize()[0] for l in lj]
    # the reference's assembled layouts (ELL, DIA, the factored prol_sa) are CSR here
    csr = {"aij_dnd": "aij_dnd", "interp_q1": "interp_q1"}
    assert [l.A.meta[0] for l in lp] == [csr.get(l.A.meta[0], "aij_csr") for l in lj]
    assert [l.P.meta[0] for l in lp[:-1]] == [csr.get(l.P.meta[0], "aij_csr") for l in lj[:-1]]
    return lj, lp


def test_gamg_uses_device_head_and_converges():
    """tests/test_gamg_device.py's end-to-end test: the grid operator takes
    the device head (the fine operator never comes to the host; only
    tail matrices below the limit do), and -pc_gamg_structured_device 0
    gives the host head; each as the reference."""
    n = 24
    T = sp.diags([-1, 2.0, -1], [-1, 0, 1], (n, n))
    I = sp.eye(n)
    A_sp = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
            + sp.kron(sp.kron(I, I), T)).tocsr()
    kinds = {}
    for dev in (1, 0):
        args = ("-pc_gamg_structured_device", str(dev), "-pc_gamg_structured_limit", "300")
        calls = []
        orig = ptt.MatAIJ.to_scipy

        def spy(self, _calls=calls, _orig=orig):
            _calls.append(self.getSize())
            return _orig(self)

        ptt.MatAIJ.to_scipy = spy
        try:
            kj, kp, _ = _both(A_sp, (n, n, n), args)
        finally:
            ptt.MatAIJ.to_scipy = orig
        _same_run(kj, kp)
        assert kp.getConvergedReason().converged
        kinds[dev] = [lev.A.meta[0] for lev in kp.getPC()._impl.levels]
        if dev:
            assert all(sz[0] <= 300 for sz in calls), calls
    assert kinds[1][:2] == ["aij_dnd", "aij_dnd"], kinds[1]


@pytest.mark.parametrize("n,pts", [(16, 7), (17, 7), (16, 27)])
def test_structured_head_converges(n, pts):
    A_sp = poisson3d(n, pts)
    kj, kp, x = _both(A_sp, (n, n, n), ("-pc_gamg_structured_limit", "200"))
    _same_run(kj, kp)
    assert kp.getConvergedReason().converged and kp.getIterationNumber() <= 15
    assert np.linalg.norm(A_sp @ x - 1) < 1e-4
    levels = kp.getPC()._impl.levels
    assert levels[0].P.meta[0] == "interp_q1"
    assert levels[1].A.meta[0] == "aij_dnd"


def test_structured_head_opt_out():
    A_sp = poisson3d(16)
    kj, kp, _ = _both(A_sp, (16, 16, 16), ("-pc_gamg_structured_coarsening", "0"))
    _same_run(kj, kp)
    assert kp.getPC()._impl.levels[0].P.meta[0] != "interp_q1"


def test_no_grid_no_structured_head():
    A_sp = poisson3d(12)
    kj, kp, _ = _both(A_sp, None, grid=False)
    _same_run(kj, kp)
    assert all(lev.P.meta[0] != "interp_q1" for lev in kp.getPC()._impl.levels[:-1])


def test_amat_pmat_split_gamg():
    """tests/test_stencil_const.py's Amat/Pmat contract: the stencil operator
    applied, a host_only CSR Pmat driving the set-up, never built on the
    device; the device head runs on the Amat."""
    from examples.poisson_scale import poisson7_csr
    n = 12
    ip, ix, v = poisson7_csr(n)
    A_sp = sp.csr_matrix((v, ix, ip), shape=(n ** 3, n ** 3))
    res = []
    for pkg, sb in ((pt_jax, sb_jax), (ptt, stencil_build)):
        if pkg is ptt:
            ptt.init(device="cpu")
        else:
            pt_jax.init()
        A = sb.as_mat(*sb.build_dnd((n,) * 3, kind="star"))
        Pm = pkg.MatAIJ.from_scipy(A_sp, host_only=True)
        assert Pm._dev is None
        ksp, x = _solve(pkg, A, (), P=Pm, tol=(1e-8, 10000))
        assert ksp.getConvergedReason() > 0 and ksp.getIterationNumber() <= 12
        assert Pm._dev is None
        res.append(ksp)
    r = A.op().mult(x.array).numpy() - 1.0
    assert np.linalg.norm(r) / n ** 1.5 < 1e-7
    _same_run(*res)


# bench.py's solve at small sizes: build_dnd + as_mat, CG+GAMG with every
# option at its default, rtol 1e-8, max_it 60; rows per level from
# gamg_contract.py (PERF.md section 4)
ROWS = {16: [4096, 512, 56, 5], 32: [32768, 4096, 512, 56, 5]}
ITS = {16: 7, 32: 8}


@pytest.mark.parametrize("cycle", ("f64", "f32"))
@pytest.mark.parametrize("kind", ("box", "star"))
@pytest.mark.parametrize("n", (16, 32))
def test_device_head_end_to_end(n, kind, cycle):
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8", "-ksp_max_it", "60"]
    if cycle == "f32":
        args += ["-pc_mg_dtype", "single"]
    ksps = []
    for pkg, sb in ((pt_jax, sb_jax), (ptt, stencil_build)):
        if pkg is ptt:
            ptt.init(args=args, device="cpu")
        else:
            pt_jax.init(args=args)
        A = sb.as_mat(*sb.build_dnd((n,) * 3, kind=kind))
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        b = A.createVecLeft()
        b.set(1.0)
        x = A.createVecRight()
        ksp.solve(b, x)
        ksps.append(ksp)
    lj, lp = _same_run(*ksps, rtol=1e-6 if cycle == "f64" else 1e-4)
    assert ksps[1].getConvergedReason().name == "CONVERGED_RTOL"
    assert [lev.A.getSize()[0] for lev in lp] == ROWS[n]
    if kind == "box":
        assert ksps[1].getIterationNumber() == ITS[n]
    em, emj = np.array([l.emax for l in lp[:-1]]), np.array([l.emax for l in lj[:-1]])
    assert _rel(em, emj) <= (1e-10 if cycle == "f64" else 1e-4)
    want = torch.float32 if cycle == "f32" else torch.float64
    assert lp[1].A.device_data()["coef"].dtype == want


def test_the_head_events_are_logged():
    ptt.init(args=["-ksp_type", "cg", "-pc_type", "gamg"], device="cpu")
    ptt.log().reset()
    A = stencil_build.as_mat(*stencil_build.build_dnd((16,) * 3, kind="box"))
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.setUp()
    for ev in ("head", "tail_download", "native", "graph", "coarsen", "prol0", "emax",
               "smooth_prol", "SpGEMM"):
        assert ptt.log().get_event(f"PCGAMGSetUp_{ev}") is not None, ev
    # the device head never downloads the fine operator
    assert ptt.log().get_event("PCGAMGSetUp_download") is None


def test_what_later_slices_bring_is_refused():
    """The sharded head came with distribution: a slab level's planes (one
    rank here; tests/test_torch_dist_mat.py holds four) gather to the same
    host CSR as the one-device level's, and the head takes dnd_mpi
    stencils where asked to."""
    from petsc_tpu_torch.parallel.mesh import comm_self
    ptt.init(device="cpu")
    meta, data = stencil_build.build_dnd((6, 5, 4), kind="box")
    coef = torch.as_tensor(np.random.default_rng(4).random((27, 6, 5, 4)))
    smeta = ("aij_dnd", (6, 5, 4), tuple(product((-1, 0, 1), repeat=3)), (1,) * 3, (1,) * 3, 120)
    ext = torch.zeros((27, 8, 5, 4), dtype=coef.dtype)
    ext[:, 1:7] = coef
    mmeta = ("dnd_mpi", 1, 6, (6, 5, 4), smeta[2], 1)
    mpi = gd.mpi_to_csr(mmeta, {"coef": ext, "diag": coef[13].reshape(-1), "comm": comm_self()})
    assert (mpi != stencil_build.dnd_to_csr(smeta, {"coef": coef})).nnz == 0
    assert gd.supports_device_rap(mmeta, kinds=("dnd_mpi",)) and not gd.supports_device_rap(mmeta)
    # the head probes {-1,0,1}^d stencils only
    assert not gd.supports_device_rap(("aij_dnd", (8, 8), ((0, 0), (0, 2)), (0, 0), (0, 2), 64))
    assert not gd.supports_device_rap(MatInterpQ1((8, 8), (4, 4)).meta)


def test_a_head_down_to_the_coarse_limit_solves():
    """With a structured limit below about 400 rows the head can reach a
    grid of at most coarse_eq_limit rows, and the coarsest level, whose LU
    needs a host CSR, is then a stencil Mat. The reference fails there (its
    stencil Mat has no to_scipy: ROADMAP section 3); the port solves, with
    the hierarchy and iterations of the host head on the MatAIJ twin."""
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
            "-pc_gamg_structured_limit", "100"]
    pt_jax.init(args=args)
    with pytest.raises(AttributeError, match="to_scipy"):
        _solve(pt_jax, sb_jax.as_mat(*sb_jax.build_dnd((24,) * 3, kind="box")), args)
    runs = []
    for twin in (False, True):
        ptt.init(args=args + (["-pc_gamg_structured_device", "0"] if twin else []),
                 device="cpu")
        if twin:
            A = ptt.MatAIJ.from_scipy(stencil_build.poisson3d_27pt(24))
            A.setStencilGrid((24,) * 3)
        else:
            A = stencil_build.as_mat(*stencil_build.build_dnd((24,) * 3, kind="box"))
        ksp, _ = _solve(ptt, A, args)
        levels = ksp.getPC()._impl.levels
        runs.append((ksp.getIterationNumber(), ksp.getConvergedReason().name,
                     [lev.A.getSize()[0] for lev in levels], [lev.A.meta[0] for lev in levels]))
    assert runs[0] == runs[1]
    assert runs[0][1:] == ("CONVERGED_RTOL", [13824, 1728, 216, 27], ["aij_dnd"] * 4)


def test_a_stencil_mat_takes_the_host_head_on_request():
    """-pc_gamg_structured_device 0 on a stencil Mat: the host head on its
    downloaded CSR, as on its assembled MatAIJ twin (the reference's
    stencil Mat has no to_scipy and fails there: ROADMAP section 3)."""
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8",
            "-pc_gamg_structured_device", "0"]
    runs = []
    for twin in (False, True):
        ptt.init(args=args, device="cpu")
        if twin:
            A = ptt.MatAIJ.from_scipy(stencil_build.poisson3d_27pt(16))
            A.setStencilGrid((16,) * 3)
        else:
            A = stencil_build.as_mat(*stencil_build.build_dnd((16,) * 3, kind="box"))
        ksp, _ = _solve(ptt, A, args)
        levels = ksp.getPC()._impl.levels
        runs.append((ksp.getIterationNumber(), ksp.getConvergedReason().name,
                     [lev.A.getSize()[0] for lev in levels], [lev.emax for lev in levels[:-1]],
                     ksp.getConvergenceHistory()))
    assert runs[0][:3] == runs[1][:3] and runs[0][1] == "CONVERGED_RTOL"
    assert runs[0][2] == [4096, 512, 56, 5]
    np.testing.assert_allclose(runs[0][3], runs[1][3], rtol=1e-12)
    np.testing.assert_allclose(runs[0][4], runs[1][4], rtol=1e-10)
