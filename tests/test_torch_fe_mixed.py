"""The port's H(div)/H(curl) element families and the non-simplex
Lagrange cells (petsc_tpu_torch/dm/fe.py) against the JAX package's on
the CPU: tests/test_fe_rt0.py, test_fe_bdm1.py, test_fe_highorder.py and
test_fe_nedelec.py. Each family's assembled system (a MatAIJ) and
right-hand side equal the reference's to 1e-12; the case's own check
(elementwise conservation, a convergence rate, the de Rham kernel, a
patch energy) holds on the port; the saddle systems solve through the
port's PCFieldSplit Schur in the reference's iterations and reason, the
Maxwell system through CG + Jacobi likewise (histories to 1e-6)."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import petsc_tpu as pj
import petsc_tpu.dm.fe as R
import petsc_tpu_torch as pt
import petsc_tpu_torch.dm.fe as T
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex
from tests.plex_parity import (BOX, U_RTOL, assert_close, assert_history, dirichlet_solve,
                               fe_pair, host, init)

torch.set_num_threads(1)

W = np.pi


def _both(name, n, *a, **kw):
    """The family's outputs from both packages on the (n, n) box."""
    init()
    return (getattr(T, name)(DMPlex.createBoxMesh((n, n)), *a, **kw),
            getattr(R, name)(RPlex.createBoxMesh((n, n)), *a, **kw))


def _same_system(port, ref):
    K, rhs = port[0], port[1]
    assert_close(K, ref[0])
    if hasattr(rhs, "getArray"):
        assert_close(rhs, np.asarray(ref[1].getArray())[: K.getSize()[0]])
    return K.to_scipy(), (host(rhs) if hasattr(rhs, "getArray") else None)


def _f(x):
    return 2 * W * W * np.sin(W * x[0]) * np.sin(W * x[1])


# ------------------------------------------------------------ RT0, CR Stokes

def _rt0_div(plex, sigma):
    cells = plex.cells
    _, c2e = T.build_edges(cells)
    v = plex.coords[cells]
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    sgn = np.stack([np.where(cells[:, a] < cells[:, b], 1.0, -1.0)
                    for a, b in [(0, 1), (1, 2), (0, 2)]], axis=1)
    div = (sgn * np.array([1.0, 1.0, -1.0]) * np.sign(detJ)[:, None] * sigma[c2e]).sum(axis=1)
    return div, np.abs(detJ) / 2.0


def test_rt0_conservation_and_convergence():
    def u_exact(xy):
        u = np.zeros(len(xy))
        for k in range(1, 40, 2):
            for l in range(1, 40, 2):
                u += (16 / np.pi ** 4 * np.sin(k * np.pi * xy[:, 0]) * np.sin(l * np.pi * xy[:, 1])
                      / (k * l * (k * k + l * l)))
        return u

    errs = []
    for n in (8, 16):
        port, ref = _both("rt0_mixed_poisson", n, f=1.0)
        Ks, rhs = _same_system(port, ref)
        assert port[2] == ref[2]
        ne = port[2]
        s = spla.spsolve(Ks.tocsc(), rhs)
        plex = DMPlex.createBoxMesh((n, n))
        div, area = _rt0_div(plex, s[:ne])
        assert np.abs(div + area).max() < 1e-12
        errs.append(np.sqrt((area * (s[ne:] - u_exact(plex.coords[plex.cells].mean(axis=1)))
                             ** 2).sum()))
    assert np.log2(errs[0] / errs[1]) > 1.4, errs


def _schur_solve(pk, K, rhs, nsplit, extra=()):
    pk.init(args=["-pc_type", "fieldsplit", "-pc_fieldsplit_type", "schur",
                  "-pc_fieldsplit_schur_precondition", "selfp", "-ksp_type", "fgmres", *extra],
            **({"device": "cpu"} if pk is pt else {}))
    ksp = pk.KSP().create()
    ksp.setOperators(K)
    ksp.setTolerances(rtol=1e-10, max_it=400)
    ksp.setFromOptions()
    n = K.getSize()[0]
    ksp.getPC()._impl.setIS("0", np.arange(nsplit))
    ksp.getPC()._impl.setIS("1", np.arange(nsplit, n))
    x = K.createVecRight()
    ksp.solve(rhs, x)
    return ksp, host(x)[:n]


@pytest.mark.parametrize("family", ["rt0_mixed_poisson", "bdm1_mixed_poisson"])
def test_hdiv_fieldsplit_schur_solve(family):
    """The saddle systems through PCFieldSplit Schur (selfp) + FGMRES: the
    reference's iterations, reason, history and solution."""
    port, ref = _both(family, 8, f=1.0)
    kp, xp = _schur_solve(pt, port[0], port[1], port[2])
    kr, xr = _schur_solve(pj, ref[0], ref[1], ref[2])
    assert kp.getIterationNumber() == kr.getIterationNumber()
    assert int(kp.getConvergedReason()) == int(kr.getConvergedReason()) > 0
    assert_history(kp.getConvergenceHistory(), kr.getConvergenceHistory())
    xr = np.asarray(xr)[: len(xp)]
    assert np.linalg.norm(xp - xr) <= U_RTOL * np.linalg.norm(xr)
    if family == "rt0_mixed_poisson":
        div, area = _rt0_div(DMPlex.createBoxMesh((8, 8)), xp[: port[2]])
        assert np.abs(div + area).max() < 1e-8


def test_cr_stokes_exactly_divergence_free():
    port, ref = _both("cr_stokes_system", 8, f=(0.0, -1.0))
    Ks, rhs = _same_system(port, ref)
    nvel = port[2]
    plex = DMPlex.createBoxMesh((8, 8))
    edges, c2e = T.build_edges(plex.cells)
    mid = 0.5 * (plex.coords[edges[:, 0]] + plex.coords[edges[:, 1]])
    bnd_e = np.nonzero((mid.min(axis=1) < 1e-9) | (mid.max(axis=1) > 1 - 1e-9))[0]
    pinned = np.concatenate([2 * bnd_e, 2 * bnd_e + 1, [nvel]])
    keep = np.ones(Ks.shape[0], bool)
    keep[pinned] = False
    s = np.zeros(Ks.shape[0])
    s[keep] = spla.spsolve(Ks[keep][:, keep].tocsc(), rhs[keep])
    g, vol = T.cr_cell_gradients(plex.coords, plex.cells)
    gr, _ = R.cr_cell_gradients(plex.coords, plex.cells)
    assert np.array_equal(g, gr)
    ux, uy = s[:nvel:2][c2e], s[1:nvel:2][c2e]
    div = (g[:, :, 0] * ux + g[:, :, 1] * uy).sum(axis=1)
    assert np.abs(div).max() < 1e-11


# ------------------------------------------------------------ BDM1, RT1

def _bdm1_err(n, ref=True):
    init()
    gs = lambda xq: W * np.stack([np.cos(W * xq[..., 0]) * np.sin(W * xq[..., 1]),   # noqa: E731
                                  np.sin(W * xq[..., 0]) * np.cos(W * xq[..., 1])], axis=-1)
    port = T.bdm1_mixed_poisson(DMPlex.createBoxMesh((n, n)), f=_f)
    if ref:
        Ks, rhs = _same_system(port, R.bdm1_mixed_poisson(RPlex.createBoxMesh((n, n)), f=_f))
    else:
        Ks, rhs = port[0].to_scipy(), host(port[1])
    s = spla.spsolve(Ks.tocsc(), rhs)
    ns = port[2]
    sig, xq, wdet = port[3](s[:ns])
    nc = Ks.shape[0] - ns
    assert np.abs(Ks[ns:, :ns] @ s[:ns] - rhs[ns: ns + nc]).max() < 1e-11
    return np.sqrt(float((wdet * ((sig - gs(xq)) ** 2).sum(axis=-1)).sum()))


def test_bdm1_flux_second_order_and_conservation():
    e1, e2 = _bdm1_err(8), _bdm1_err(16, ref=False)
    assert np.log2(e1 / e2) > 1.7, (e1, e2)


def _rt1_errors(n, ref=True):
    init()
    port = T.rt1_mixed_poisson(DMPlex.createBoxMesh((n, n)), f=_f)
    if ref:
        Ks, rhs = _same_system(port, R.rt1_mixed_poisson(RPlex.createBoxMesh((n, n)), f=_f))
    else:
        Ks, rhs = port[0].to_scipy(), host(port[1])
    s = spla.spsolve(Ks.tocsc(), rhs)
    sig, xq, wdet = port[3](s)
    sx = W * np.cos(W * xq[..., 0]) * np.sin(W * xq[..., 1])
    sy = W * np.sin(W * xq[..., 0]) * np.cos(W * xq[..., 1])
    esig = np.sqrt((wdet * ((sig[..., 0] - sx) ** 2 + (sig[..., 1] - sy) ** 2)).sum())
    uh, xq, wdet = port[4](s)
    eu = np.sqrt((wdet * (uh - np.sin(W * xq[..., 0]) * np.sin(W * xq[..., 1])) ** 2).sum())
    return esig, eu


def test_rt1_second_order_flux_and_potential():
    (s1, u1), (s2, u2) = _rt1_errors(6), _rt1_errors(12, ref=False)
    assert np.log2(s1 / s2) > 1.7 and np.log2(u1 / u2) > 1.7, (s1, s2, u1, u2)


def test_rt1_elementwise_conservation():
    port, ref = _both("rt1_mixed_poisson", 6, f=1.0)
    Ks, rhs = _same_system(port, ref)
    s = spla.spsolve(Ks.tocsc(), rhs)
    assert np.abs((Ks @ s - rhs)[port[2]:]).max() < 1e-10


# ------------------------------------------------------------ Nedelec

def _E(x):
    return np.array([np.sin(W * x[1]), np.sin(W * x[0])])


def test_nedelec1_interpolation_and_solve_second_order():
    def errs(n, ref):
        init()
        plex = DMPlex.createBoxMesh((n, n))
        K, dofs, eval_E, edges = T.nedelec1_curlcurl(plex, alpha=1.0, beta=1.0)
        if ref:
            Kr, dofs_r, _, edges_r = R.nedelec1_curlcurl(RPlex.createBoxMesh((n, n)))
            assert_close(K, Kr)
            assert np.array_equal(edges, edges_r)
            assert np.allclose(dofs(_E), dofs_r(_E), rtol=0, atol=1e-15)
        Ks = K.to_scipy()
        ne = len(edges)
        Ms = T.nedelec1_curlcurl(plex, alpha=0.0, beta=1.0)[0].to_scipy()
        rhs = Ms @ dofs(lambda x: (W * W + 1) * _E(x))
        bset = set(plex.markBoundaryVertices().tolist())
        bedge = np.array([i for i, (a, b) in enumerate(edges) if a in bset and b in bset])
        fix = np.zeros(2 * ne, bool)
        fix[2 * bedge] = fix[2 * bedge + 1] = True
        sex = dofs(_E)
        s = sex * fix
        keep = ~fix
        s[keep] = spla.spsolve(Ks[keep][:, keep].tocsc(), (rhs - Ks @ (sex * fix))[keep])
        out = []
        for v in (dofs(_E), s):
            Eh, xq, wdet = eval_E(v)
            out.append(np.sqrt((wdet * ((Eh[..., 0] - np.sin(W * xq[..., 1])) ** 2
                                        + (Eh[..., 1] - np.sin(W * xq[..., 0])) ** 2)).sum()))
        return out

    (i1, s1), (i2, s2) = errs(8, True), errs(16, False)
    assert np.log2(i1 / i2) > 1.8 and np.log2(s1 / s2) > 1.8, (i1, i2, s1, s2)


def test_nedelec1_spd_and_gradient_kernel():
    port, ref = _both("nedelec1_curlcurl", 4, alpha=1.0, beta=0.0)
    assert_close(port[0], ref[0])
    Ks = port[0].to_scipy().toarray()
    assert np.abs(Ks - Ks.T).max() < 1e-10
    for g in (lambda x: np.array([1.0, 2.0]), lambda x: np.array([x[0], -x[1]])):
        assert np.abs(Ks @ port[1](g)).max() < 1e-10


def test_nedelec0_de_rham_and_constant_energy():
    init()
    plex = DMPlex.createBoxMesh((7, 9))
    K, G, edges = T.nedelec0_curlcurl(plex, alpha=1.0, beta=0.0)
    Kr, Gr, _ = R.nedelec0_curlcurl(RPlex.createBoxMesh((7, 9)), alpha=1.0, beta=0.0)
    assert_close(K, Kr)
    assert (G != Gr).nnz == 0
    Ev = G @ np.random.default_rng(0).random(plex.nvertices)
    assert np.abs(K.to_scipy() @ Ev).max() < 1e-12 * max(np.abs(Ev).max(), 1.0)
    plex = DMPlex.createBoxMesh((6, 6))
    K, G, edges = T.nedelec0_curlcurl(plex, alpha=0.0, beta=1.0)
    c = np.array([0.3, -0.7])
    d = (plex.coords[edges.max(axis=1)] - plex.coords[edges.min(axis=1)]) @ c
    assert abs(float(d @ (K.to_scipy() @ d)) - c @ c) < 1e-12


def test_nedelec0_definite_maxwell_cg():
    """alpha curlcurl + beta mass by CG + Jacobi: the reference's
    iterations, reason, solution and the first 50 history entries (the
    reference's own history parts by more than 1e-6 from entry 53 on when
    b moves by 1e-15 relative, and takes 160 iterations for 158: ROADMAP
    section 3)."""
    port, ref = _both("nedelec0_curlcurl", 10, alpha=1.0, beta=1.0)
    runs = []
    for pk, K in ((pt, port[0]), (pj, ref[0])):
        pk.init(args=[], **({"device": "cpu"} if pk is pt else {}))
        ksp = pk.KSP().create()
        ksp.setOperators(K)
        ksp.setType("cg")
        ksp.getPC().setType("jacobi")
        ksp.setTolerances(rtol=1e-9, max_it=2000)
        b = K.createVecLeft()
        b.set(1.0)
        x = K.createVecRight()
        ksp.solve(b, x)
        runs.append((ksp, host(x)[: K.getSize()[0]]))
    (kp, xp), (kr, xr) = runs
    assert kp.getIterationNumber() == kr.getIterationNumber()
    assert int(kp.getConvergedReason()) == int(kr.getConvergedReason()) > 0
    assert_history(kp.getConvergenceHistory()[:50], kr.getConvergenceHistory()[:50])
    assert np.linalg.norm(xp - xr) <= U_RTOL * np.linalg.norm(xr)
    ne = port[0].getSize()[0]
    assert np.linalg.norm(port[0].to_scipy() @ xp - 1.0) / np.sqrt(ne) < 1e-7


# ------------------------------------------------------------ prism and Q2 hex

def _poisson3(m, x):
    return 3 * W * W * m.sin(W * x[0]) * m.sin(W * x[1]) * m.sin(W * x[2])


def _cube_error(ds):
    u = dirichlet_solve(ds, ds.boundary_dofs(BOX))
    X = ds.dof_coords
    return np.abs(u - np.sin(W * X[:, 0]) * np.sin(W * X[:, 1]) * np.sin(W * X[:, 2])).max()


@pytest.mark.parametrize("k,ns,rate", [(1, (4, 8), 1.5), (2, (3, 6), 2.4)])
def test_prism_poisson_converges(k, ns, rate):
    forms = lambda m: (lambda u, gu, x: -_poisson3(m, x), lambda u, gu, x: gu)   # noqa: E731
    errs = []
    for i, n in enumerate(ns):
        ds, _ = fe_pair(None, (3, k), forms, fe_kw={"cell": "prism"}, ref=i == 0,
                        mesh=lambda P, n=n: P.createBoxMesh((n, n)).extrudeToPrisms(n))
        errs.append(_cube_error(ds))
    assert np.log2(errs[0] / errs[1]) > rate, errs


def test_prism_quadrature_tables_and_boundary():
    qp, qw = T.prism_quadrature(4)
    assert abs(qw.sum() - 0.5) < 1e-13
    assert abs(float((qw * qp[:, 0] ** 2 * qp[:, 2] ** 2).sum()) - (1 / 12) * (1 / 3)) < 1e-13
    for k in (1, 2):
        fe = T.lagrange_fe(3, k, "prism")
        assert fe.nb == (6 if k == 1 else 18)
        assert np.allclose(fe.B.sum(axis=1), 1.0, atol=1e-11)
    p = DMPlex.createBoxMesh((3, 3)).extrudeToPrisms(3)
    X = p.coords
    on = (X.min(axis=1) < 1e-12) | (X.max(axis=1) > 1 - 1e-12)
    assert set(p.markBoundaryVertices().tolist()) == set(np.nonzero(on)[0].tolist())


def test_q2_hex_counts_and_poisson_converges():
    fe = T.lagrange_fe(3, 2, "tensor")
    kinds = [kk[0] for kk in fe.node_kinds]
    assert fe.nb == 27 and (kinds.count("vertex"), kinds.count("edge"), kinds.count("face"),
                            kinds.count("interior")) == (8, 12, 6, 1)
    forms = lambda m: (lambda u, gu, x: -_poisson3(m, x), lambda u, gu, x: gu)   # noqa: E731
    e1 = _cube_error(fe_pair((2, 2, 2), (3, 2, "tensor"), forms, simplex=False)[0])
    e2 = _cube_error(fe_pair((4, 4, 4), (3, 2, "tensor"), forms, simplex=False, ref=False)[0])
    assert np.log2(e1 / e2) > 2.5, (e1, e2)
