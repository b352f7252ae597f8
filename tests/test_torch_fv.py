"""The port's finite volumes (petsc_tpu_torch/dm/fv.py, fv_plex.py) against
the JAX package's on the CPU: tests/test_fv.py's limiters, TVD advection
and Burgers shock through TS ssp, and tests/test_fv_plex.py's face
geometry, first-order convergence on a Gmsh mesh, second order against
first, Barth-Jespersen bounds and Rusanov on tets and quads with TS; plus
face_geometry's and the least-squares tables' numbering equal to the
reference's (vectorised), the right-hand side of every riemann/order/
limiter/boundary choice to 1e-12, X1's signed and min tables against the
reference's .at[].add / .at[].min bit for bit, and the SSP-RK2 advection
of phase plex's fvplex_advect_724 at small size held to FV_TOL (1e-10) of
max|u|.

Flux and wave-speed functions are written once against an array module m
(jax.numpy or torch)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import petsc_tpu as pj
import petsc_tpu_torch as pt
import petsc_tpu.dm.fv as RFV
import petsc_tpu.dm.fv_plex as RFP
import petsc_tpu_torch.dm.fv as TFV
import petsc_tpu_torch.dm.fv_plex as TFP
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex
from petsc_tpu_torch.ops import pc_kernels as pck
from tests.plex_parity import FV_TOL, assert_close, host, init

torch.set_num_threads(1)

GMSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Nodes
1 5 1 5
2 1 0 5
1
2
3
4
5
0 0 0
1 0 0
1 1 0
0 1 0
0.55 0.45 0
$EndNodes
$Elements
1 4 1 4
2 1 2 4
1 1 2 5
2 2 3 5
3 3 4 5
4 4 1 5
$EndElements
$EndMesh
"""


def _bump(cc):
    return np.exp(-((cc[:, 0] - 0.3) ** 2 + (cc[:, 1] - 0.3) ** 2) / 0.02)


def _advect_port(mesh, T=0.25, vel=(1.0, 0.5), order=1, limiter="barth", cfl=0.4):
    """tests/test_fv_plex.py's _advect (SSP-RK2 from the bump) through the
    port: (u_final, exact, cell volumes, steps)."""
    g = TFP.face_geometry(mesh)
    vx, vy = vel
    fv = TFP.FVPlex(mesh, lambda u: (vx * u, vy * u),
                    lambda uL, uR, n: vx * n[:, 0] + vy * n[:, 1], riemann="upwind",
                    bc="outflow", order=order, limiter=limiter)
    rhs = fv.makeRHS()
    cc = g["ccent"]
    u = torch.as_tensor(_bump(cc))
    h = float(np.sqrt(g["vol"].min()))
    nst = int(np.ceil(T / (cfl * h / np.hypot(vx, vy))))
    dt = T / nst
    for _ in range(nst):
        u1 = u + dt * rhs(0.0, u)
        u = 0.5 * (u + u1 + dt * rhs(0.0, u1))
    exact = _bump(np.stack([cc[:, 0] - vx * T, cc[:, 1] - vy * T], axis=1))
    return host(u), exact, g["vol"], nst


def _advect_ref(mesh, T=0.25, vel=(1.0, 0.5), order=1, limiter="barth", cfl=0.4):
    g = RFP.face_geometry(mesh)
    vx, vy = vel
    fv = RFP.FVPlex(mesh, lambda u: (vx * u, vy * u),
                    lambda uL, uR, n: vx * n[:, 0] + vy * n[:, 1], riemann="upwind",
                    bc="outflow", order=order, limiter=limiter)
    rhs = fv.makeRHS()
    u = jnp.asarray(_bump(g["ccent"]))
    h = float(np.sqrt(g["vol"].min()))
    nst = int(np.ceil(T / (cfl * h / np.hypot(vx, vy))))
    dt = T / nst

    @jax.jit
    def step(u):
        k1 = rhs(0.0, u)
        u1 = u + dt * k1
        return 0.5 * (u + u1 + dt * rhs(0.0, u1))

    for _ in range(nst):
        u = step(u)
    return np.asarray(u), nst


# ------------------------------------------------------------ tests/test_fv.py

def test_limiters_properties():
    r = np.linspace(-2, 4, 61)
    for name in ("minmod", "vanleer", "mc", "superbee", "none", "zero"):
        phi = host(TFV.limiter(name)(torch.as_tensor(r)))
        assert np.array_equal(phi, np.asarray(RFV.limiter(name)(jnp.asarray(r))))
        assert phi.min() >= 0.0
        if name not in ("zero",):
            assert np.isclose(float(TFV.limiter(name)(torch.tensor(1.0, dtype=torch.float64))),
                              1.0)
    with pytest.raises(KeyError):
        TFV.limiter("nope")


def _advect_1d(pk, fvmod, m, n=64, order=2, lim="minmod", T=1.0, burgers=False):
    pk.init(args=[], **({"device": "cpu"} if pk is pt else {}))
    da = pk.DMDA.create(dim=1, sizes=(n,), boundary_type="periodic")
    if burgers:
        fv = fvmod.FV(da, flux=lambda u: 0.5 * u * u, wavespeed=lambda u: u,
                      limiter_type="minmod")
        dt = 0.2 / n
    else:
        fv = fvmod.FV(da, flux=lambda u: u, wavespeed=lambda u: m.ones_like(u),
                      riemann="rusanov", limiter_type=lim, order=order)
        dt = 0.4 / n
    ts = pk.TS().create()
    ts.setType("ssp")
    ts.setRHSFunction(fv.makeRHS())
    ts.setTimeStep(dt)
    ts.setMaxTime(T)
    ts.adapt.kind = "none"
    x = (np.arange(n) + 0.5) / n
    u0 = np.where((x > 0.1) & (x < 0.4), 1.0, 0.0) if burgers else \
        np.where((x > 0.25) & (x < 0.5), 1.0, 0.0)
    u = pk.Vec.from_array(u0.astype(float))
    ts.solve(u)
    return u0, host(u)[:n], ts.getStepNumber()


@pytest.mark.parametrize("order,lim", [(2, "minmod"), (1, "minmod"), (2, "vanleer"), (2, "mc"),
                                       (2, "superbee")])
def test_structured_fv_advection_equals_the_reference(order, lim):
    """MUSCL advection of a square wave over a period through TS ssp: the
    reference's steps and state (1e-10 of max|u|), TVD for minmod, and
    second order beats first (tests/test_fv.py)."""
    u0, uT, n_t = _advect_1d(pt, TFV, torch, order=order, lim=lim)
    _, uR, n_r = _advect_1d(pj, RFV, jnp, order=order, lim=lim)
    assert n_t == n_r
    assert np.abs(uT - uR).max() <= FV_TOL * np.abs(uR).max()
    if lim == "minmod" and order == 2:
        assert uT.min() >= -1e-10 and uT.max() <= 1.0 + 1e-10
        assert np.linalg.norm(uT - u0, 1) / len(u0) < 0.1
        _, u1, _ = _advect_1d(pt, TFV, torch, order=1)
        assert np.linalg.norm(uT - u0, 1) < 0.7 * np.linalg.norm(u1 - u0, 1)


def test_burgers_shock_speed():
    u0, uT, _ = _advect_1d(pt, TFV, torch, n=128, T=0.25, burgers=True)
    _, uR, _ = _advect_1d(pj, RFV, jnp, n=128, T=0.25, burgers=True)
    assert np.abs(uT - uR).max() <= FV_TOL
    x = (np.arange(128) + 0.5) / 128
    assert abs(x[np.argmax(np.abs(np.diff(uT)))] - 0.525) < 0.03


def test_structured_fv_2d_rhs():
    """The 2-D periodic DMDA right-hand side of both Riemann solvers with
    the mc limiter, to 1e-12 of the reference's."""
    init()
    dat, dar = pt.DMDA.create(2, (9, 7), boundary_type="periodic"), \
        pj.DMDA.create(2, (9, 7), boundary_type="periodic")
    u = np.random.default_rng(4).standard_normal(63)
    for riem in ("rusanov", "upwind"):
        a = TFV.FV(dat, lambda u: u * u, lambda u: 2 * u, riemann=riem, limiter_type="mc")
        b = RFV.FV(dar, lambda u: u * u, lambda u: 2 * u, riemann=riem, limiter_type="mc")
        assert_close(a.makeRHS()(0.0, torch.as_tensor(u)), np.asarray(b.makeRHS()(0.0, jnp.asarray(u))))


# ------------------------------------------------------------ tests/test_fv_plex.py

@pytest.mark.parametrize("faces,simplex", [((5, 4), True), ((6, 5), False), ((2, 2, 2), True),
                                           ((17, 13), True)])
def test_face_geometry_and_ls_tables_equal_the_reference(faces, simplex):
    """face_geometry (vectorised) and the least-squares tables: the
    reference's face order, left/right cells, normals, areas, centroids,
    neighbour order and pseudo-inverses; the discrete divergence theorem."""
    p, r = DMPlex.createBoxMesh(faces, simplex=simplex), RPlex.createBoxMesh(faces, simplex=simplex)
    g, gr = TFP.face_geometry(p), RFP.face_geometry(r)
    for k in gr:
        assert np.array_equal(g[k], gr[k]), k
    acc = np.zeros((p.ncells, p.dim))
    np.add.at(acc, g["cL"], g["normal"] * g["area"][:, None])
    inner = g["cR"] >= 0
    np.add.at(acc, g["cR"][inner], -(g["normal"] * g["area"][:, None])[inner])
    assert np.abs(acc).max() < 1e-13 and abs(g["vol"].sum() - 1.0) < 1e-12
    flux = lambda u: tuple(u for _ in range(p.dim))        # noqa: E731
    ws = lambda uL, uR, n: n[:, 0]                         # noqa: E731
    a = TFP.FVPlex(p, flux, ws, order=2)
    b = RFP.FVPlex(r, flux, ws, order=2)
    for k in ("nb", "mask", "pinv"):
        assert np.array_equal(a._ls[k], np.asarray(b._ls[k])), k


@pytest.mark.parametrize("riemann", ["upwind", "rusanov"])
@pytest.mark.parametrize("order,limiter,bc", [(1, "barth", "outflow"), (2, "barth", "outflow"),
                                              (2, "none", "outflow"), (2, "other", "outflow"),
                                              (2, "barth", ("dirichlet", 0.25)),
                                              (2, "barth", "dirichlet_fn")])
def test_rhs_equals_the_reference(riemann, order, limiter, bc):
    init()
    p, r = DMPlex.createBoxMesh((7, 6)), RPlex.createBoxMesh((7, 6))
    if bc == "dirichlet_fn":
        bc = ("dirichlet", lambda xf: np.sin(3 * xf[:, 0]) + xf[:, 1])
    u = np.random.default_rng(6).standard_normal(p.ncells + 3)     # padded as a Vec may be
    out = []
    for mod, mesh, m, arr in ((TFP, p, torch, torch.as_tensor), (RFP, r, jnp, jnp.asarray)):
        fv = mod.FVPlex(mesh, lambda u: (u * u, 0.5 * u),
                        lambda uL, uR, n, m=m: 2 * m.maximum(m.abs(uL), m.abs(uR)) * n[:, 0]
                        + 0.5 * n[:, 1], riemann=riemann, bc=bc, order=order, limiter=limiter)
        out.append(host(fv.makeRHS()(0.0, arr(u))))
    assert out[0].shape == (p.ncells + 3,)
    assert_close(out[0], out[1])


def test_x1_signed_and_min_tables_equal_the_reference_scatters():
    """FVPlex's two X1 tables on the plain version: the signed face-flux
    table against .at[cL].add(-fa) then .at[cR].add(fa), the min table
    against the limiter's two .at[].min, bit for bit."""
    init()
    p = DMPlex.createBoxMesh((9, 8))
    fv = TFP.FVPlex(p, lambda u: (u, u), lambda uL, uR, n: n[:, 0], order=2)
    tab = fv._tables()
    g = fv.geom
    nc, nf = p.ncells, len(g["cL"])
    cL, cRr, inter = g["cL"], np.maximum(g["cR"], 0), g["cR"] >= 0
    rng = np.random.default_rng(8)
    fa, aL, aR = rng.standard_normal(nf), rng.random(nf), rng.random(nf)
    got = host(pck.dst_scatter(tab["flux_scatter"], torch.as_tensor(fa)))
    ref = jnp.zeros(nc).at[cL].add(-jnp.asarray(fa))
    ref = ref.at[cRr].add(jnp.where(inter, jnp.asarray(fa), 0.0))
    assert np.array_equal(got, np.asarray(ref))
    lim = pck.dst_scatter(tab["lim_scatter"], torch.as_tensor(np.concatenate([aL, aR])),
                          out=torch.ones(nc, dtype=torch.float64), mode="min")
    ref = jnp.ones(nc).at[cL].min(jnp.asarray(aL)).at[cRr].min(jnp.where(inter, aR, 1.0))
    assert np.array_equal(host(lim), np.asarray(ref))


def test_advection_first_order_convergence_gmsh(tmp_path):
    """First-order upwind on the refined Gmsh fan: the reference's steps
    and state on the first mesh; the L1 error drops by >= 1.6x per
    refinement."""
    init()
    msh = tmp_path / "sq.msh"
    msh.write_text(GMSH41)
    m, mr = DMPlex.createFromGmsh(str(msh)), RPlex.createFromGmsh(str(msh))
    errs = []
    for lvl in range(3):
        for _ in range(2 if lvl == 0 else 1):
            m, mr = m.refine(), mr.refine()
        u, ex, vol, nst = _advect_port(m, order=1)
        if lvl == 0:
            ur, nr = _advect_ref(mr, order=1)
            assert nst == nr and np.abs(u - ur).max() <= FV_TOL * np.abs(ur).max()
        errs.append(float(np.sum(np.abs(u - ex) * vol)))
    assert errs[0] / errs[1] > 1.6 and errs[1] / errs[2] > 1.6, errs


def test_second_order_beats_first_and_small_fvplex_case():
    """phase plex's fvplex_advect_724 at 24^2 faces (upwind, order 2, Barth,
    SSP-RK2, cfl 0.4, T 0.05): the reference's steps and state to 1e-10 of
    max|u|; order 2 beats order 1 at T 0.25 (tests/test_fv_plex.py)."""
    init()
    m, mr = DMPlex.createBoxMesh((24, 24)), RPlex.createBoxMesh((24, 24))
    u, _, _, nst = _advect_port(m, T=0.05, order=2)
    ur, nr = _advect_ref(mr, T=0.05, order=2)
    assert nst == nr and np.abs(u - ur).max() <= FV_TOL * np.abs(ur).max()
    u1, ex, vol, _ = _advect_port(m, order=1)
    u2, _, _, _ = _advect_port(m, order=2)
    assert np.sum(np.abs(u2 - ex) * vol) < 0.6 * np.sum(np.abs(u1 - ex) * vol)


def test_barth_jespersen_tvd_bounds():
    init()
    m = DMPlex.createBoxMesh((20, 20))
    g = TFP.face_geometry(m)

    def run(limiter):
        fv = TFP.FVPlex(m, lambda u: (1.0 * u, 0.0 * u), lambda uL, uR, n: n[:, 0],
                        riemann="upwind", bc="outflow", order=2, limiter=limiter)
        rhs = fv.makeRHS()
        u = torch.as_tensor((g["ccent"][:, 0] < 0.4).astype(np.float64))
        dt = 0.3 * float(np.sqrt(g["vol"].min()))
        for _ in range(int(0.2 / dt)):
            u1 = u + dt * rhs(0.0, u)
            u = 0.5 * (u + u1 + dt * rhs(0.0, u1))
        return host(u)

    u_lim, u_unl = run("barth"), run("none")
    assert u_lim.min() > -1e-10 and u_lim.max() < 1.0 + 1e-10
    assert u_unl.max() > 1.0 + 1e-4 or u_unl.min() < -1e-4


def test_rusanov_tet_quad_with_ts():
    """Rusanov on a tet and a quad mesh through TS ssp's device loop
    (solveCompiled): the reference's state to 1e-10 of max|u|."""
    for faces, simplex in (((3, 3, 3), True), ((8, 8), False)):
        init()
        out = []
        for pk, mod, P, m in ((pt, TFP, DMPlex, torch), (pj, RFP, RPlex, jnp)):
            mesh = P.createBoxMesh(faces, simplex=simplex)
            g = mod.face_geometry(mesh)
            dim = g["ccent"].shape[1]
            fv = mod.FVPlex(mesh, lambda u, dim=dim: tuple(u if d == 0 else 0.5 * u
                                                          for d in range(dim)),
                            lambda uL, uR, n, m=m: m.abs(n[:, 0] + 0.5 * sum(
                                n[:, d] for d in range(1, n.shape[1]))) + 0.0 * uL,
                            riemann="rusanov", bc="outflow", order=1)
            rhs = fv.makeRHS()
            ts = pk.TS().create()
            ts.setType("ssp")
            ts.setRHSFunction(lambda t, u, rhs=rhs: rhs(t, u))
            u0 = np.exp(-10 * np.sum((g["ccent"] - 0.4) ** 2, axis=1))
            ts.setTimeStep(0.2 * float(g["vol"].min()) ** (1.0 / dim))
            ts.setMaxTime(0.05)
            u = ts.solveCompiled(torch.as_tensor(u0) if m is torch else jnp.asarray(u0))
            out.append(host(u[0] if isinstance(u, tuple) else u)[: mesh.ncells])
        assert np.all(np.isfinite(out[0])) and out[0].max() <= 1.05 and out[0].min() >= -0.05
        assert np.abs(out[0] - out[1]).max() <= FV_TOL * np.abs(out[1]).max()
