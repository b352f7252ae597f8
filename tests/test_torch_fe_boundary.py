"""The port's boundary-integral weak forms and curved geometry
(petsc_tpu_torch/dm/fe.py) against the JAX package's on the CPU:
tests/test_fe_boundary.py and test_fe_curved.py, each case's residual
and Jacobian at seeded inputs to 1e-12 relative of the reference's on
the coarser mesh and its convergence rate on the port; and the COO
Jacobian (DS.assembleJacobianCOO, ex12's route on the card) against the
reference's scipy callback: the same stored pattern, values to 1e-12.

User pointwise functions are written once against an array module m
(jax.numpy or torch), out of place."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import petsc_tpu.dm.fe as R
import petsc_tpu_torch.dm.fe as T
import petsc_tpu_torch as pt
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex
from tests.plex_parity import (BOX, assert_close, assert_same_pattern, dirichlet_solve, fe_pair,
                               host, init)

torch.set_num_threads(1)


# ------------------------------------------------------------ tests/test_fe_boundary.py

def _uex(m, dim):
    if dim == 2:
        return (lambda x: m.exp(x[0] + 0.5 * x[1]),
                lambda x: m.stack([m.exp(x[0] + 0.5 * x[1]), 0.5 * m.exp(x[0] + 0.5 * x[1])]),
                lambda x: -1.25 * m.exp(x[0] + 0.5 * x[1]))
    e = lambda x: m.exp(x[0] + 0.5 * x[1] - 0.25 * x[2])  # noqa: E731
    return (e, lambda x: m.stack([e(x), 0.5 * e(x), -0.25 * e(x)]),
            lambda x: -(1 + 0.25 + 0.0625) * e(x))


def _neumann(mk_fe, faces, dim, robin=0.0, ref=True):
    def build(m, mod, P):
        ds = mod.DS(P.createBoxMesh(faces, simplex=True), mk_fe(mod))
        uex, guex, f = _uex(m, dim)
        ds.setResidual(f0=lambda u_, gu, x: -f(x), f1=lambda u_, gu, x: gu)
        if robin:
            ds.setBdResidual(lambda u, x, n: robin * u - (n @ guex(x) + robin * uex(x)),
                             predicate=lambda c: c[0] > 1e-6)
        else:
            ds.setBdResidual(lambda u, x, n: -(n @ guex(x)), predicate=lambda c: c[0] > 1e-6)
        return ds

    init()
    ds = build(torch, T, DMPlex)
    if ref:
        dr = build(jnp, R, RPlex)
        u = np.random.default_rng(3).standard_normal(ds.ndof)
        assert_close(ds.assembleResidual(u), np.asarray(dr.assembleResidual(u)))
        assert_close(ds.assembleJacobian(u), dr.assembleJacobian(u))
    X = ds.dof_coords
    ue = np.exp(X[:, 0] + 0.5 * X[:, 1] - (0.25 * X[:, 2] if dim == 3 else 0.0))
    bnd = ds.boundary_dofs(lambda x: x[0] < 1e-9)
    u = dirichlet_solve(ds, bnd, ue[bnd])
    return float(np.abs(u - ue).max())


@pytest.mark.parametrize("kind,order", [("p1", 2.0), ("p2", 3.0)])
def test_neumann_convergence_2d(kind, order):
    mk = (lambda mod: mod.lagrange_fe(2, 1)) if kind == "p1" else (lambda mod: mod.FE.create("p2"))
    e1, e2 = _neumann(mk, (6, 6), 2), _neumann(mk, (12, 12), 2, ref=False)
    assert np.log2(e1 / e2) > order - 0.6, (e1, e2)


def test_neumann_convergence_3d_p1():
    mk = lambda mod: mod.lagrange_fe(3, 1)   # noqa: E731
    e1, e2 = _neumann(mk, (3, 3, 3), 3), _neumann(mk, (6, 6, 6), 3, ref=False)
    assert np.log2(e1 / e2) > 1.4, (e1, e2)


def test_robin_convergence_2d_p1():
    mk = lambda mod: mod.lagrange_fe(2, 1)   # noqa: E731
    e1, e2 = _neumann(mk, (6, 6), 2, robin=2.5), _neumann(mk, (12, 12), 2, robin=2.5, ref=False)
    assert np.log2(e1 / e2) > 1.4, (e1, e2)


def test_bd_jacobian_is_tangent_of_bd_residual():
    init()
    ds = T.DS(DMPlex.createBoxMesh((4, 4)), T.lagrange_fe(2, 1))
    ds.setResidual(f1=lambda u_, gu, x: gu)
    ds.setBdResidual(lambda u, x, n: 3.0 * u ** 2 - x[0])
    rng = np.random.default_rng(7)
    u = rng.standard_normal(ds.ndof)
    du = rng.standard_normal(ds.ndof) * 1e-6
    dF = host(ds.assembleResidual(u + du)) - host(ds.assembleResidual(u))
    np.testing.assert_allclose(dF, ds.assembleJacobian(u) @ du, rtol=2e-4, atol=1e-12)


# ------------------------------------------------------------ tests/test_fe_curved.py

def _disk(P, nr):
    pts, rings = [(0.0, 0.0)], []
    for i in range(1, nr + 1):
        n = 6 * i
        th = 2 * np.pi * np.arange(n) / n
        rings.append(np.arange(len(pts), len(pts) + n))
        pts += [(i / nr * np.cos(t), i / nr * np.sin(t)) for t in th]
    cells = [[0, rings[0][k], rings[0][(k + 1) % 6]] for k in range(6)]
    for i in range(1, nr):
        a, b = rings[i - 1], rings[i]
        n0, n1, ia, ib = len(a), len(b), 0, 0
        while ia < n0 or ib < n1:
            ta = (ia + 1) / n0 if ia < n0 else 1e9
            tb = (ib + 1) / n1 if ib < n1 else 1e9
            if tb <= ta:
                cells.append([a[ia % n0], b[ib % n1], b[(ib + 1) % n1]])
                ib += 1
            else:
                cells.append([a[ia % n0], b[ib % n1], a[(ia + 1) % n0]])
                ia += 1
    return P.createFromCellList(2, np.asarray(cells), np.asarray(pts))


def test_geom_p2_partition_of_unity():
    pts = np.array([[0.2, 0.3], [0.5, 0.1], [1 / 3, 1 / 3]])
    B, D = T._geom_p2_tri(pts)
    Br, Dr = R._geom_p2_tri(pts)
    assert np.array_equal(B, Br) and np.array_equal(D, Dr)
    assert np.allclose(B.sum(axis=1), 1.0, atol=1e-13) and np.allclose(D.sum(axis=1), 0.0)


def _disk_error(nr, curved, ref=True):
    def mesh(P):
        m = _disk(P, nr)
        return m.curveBoundary(lambda x: x / np.linalg.norm(x)) if curved else m

    def forms(m):
        def f(x):
            ex = m.exp(x[0])
            return -(ex * (1 - x[0] ** 2 - x[1] ** 2) - 4 * x[0] * ex - 4 * ex)
        return (lambda u, gu, x: -f(x)), (lambda u, gu, x: gu)

    ds, dr = fe_pair(None, (2, 2), forms, mesh=mesh, ref=ref)
    X = ds.dof_coords
    bnd = np.nonzero(np.linalg.norm(X, axis=1) > 1 - 1e-6)[0]
    u = dirichlet_solve(ds, bnd)
    uex = lambda x: (1 - x[0] ** 2 - x[1] ** 2) * np.exp(x[0])   # noqa: E731
    e = ds.l2_error(u, uex)
    if ref:
        assert abs(e - dr.l2_error(u, uex)) <= 1e-12 * e
    return e


def test_curved_p2_third_order_on_disk():
    e1, e2 = _disk_error(6, True), _disk_error(12, True, ref=False)
    assert np.log2(e1 / e2) > 2.6, (e1, e2)
    assert _disk_error(6, False, ref=False) > 30 * e1


def test_curved_dof_coords_and_area():
    init()
    plex = _disk(DMPlex, 6).curveBoundary(lambda x: x / np.linalg.norm(x))
    ds = T.DS(plex, T.lagrange_fe(2, 2))
    r = np.linalg.norm(ds.dof_coords, axis=1)
    assert (r > 1 - 1e-9).sum() >= 72 and np.allclose(r[r > 1 - 1e-9], 1.0, atol=1e-12)
    plex = _disk(DMPlex, 12).curveBoundary(lambda x: x / np.linalg.norm(x))
    area = T.DS(plex, T.lagrange_fe(2, 1)).l2_error(np.zeros(plex.nvertices), lambda x: 1.0) ** 2
    assert abs(area - np.pi) < 2e-4


# ------------------------------------------------------------ ex12's COO Jacobian

def test_coo_jacobian_equals_the_reference_callback():
    """DS.assembleJacobianCOO (ex12's route on the card): the pattern and
    values of the reference's scipy callback (tolil, Dirichlet rows made
    identity, their columns removed from the other rows, not stored as
    zeros), to 1e-12; the pattern kept on the next step."""
    from examples import ex12 as rex
    from petsc_tpu_torch.examples import ex12 as tex
    ds, dr = fe_pair((6, 6), (2, 2), lambda m: (
        lambda u, gu, x: -(tex.forcing(x) if m is torch else rex.forcing(x)),
        lambda u, gu, x: (1.0 + u * u) * gu))
    bnd = ds.boundary_dofs(BOX)
    u = np.random.default_rng(5).standard_normal(ds.ndof)
    A = dr.assembleJacobian(u).tolil()
    for r in bnd:
        A.rows[r] = [int(r)]
        A.data[r] = [1.0]
    coo = A.tocsr().tocoo()
    keep = ~np.isin(coo.col, bnd) | (coo.row == coo.col)
    ref = sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape)
    P = pt.MatAIJ()
    P.setSizes((ds.ndof, ds.ndof))
    ds.assembleJacobianCOO(u, P, bnd)
    got = P.to_scipy()
    assert_same_pattern(got, ref)
    assert_close(got, ref)
    plan = P._coo_plan
    ds.assembleJacobianCOO(0.5 * u, P, bnd)
    assert P._coo_plan is plan
