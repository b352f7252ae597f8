"""The port's PetscFE/PetscDS (petsc_tpu_torch/dm/fe.py) against the JAX
package's on the CPU: tests/test_fe.py, test_fe_lagrange.py and
test_fe_p4_3d.py (test_torch_fe_boundary.py holds test_fe_boundary.py,
test_fe_curved.py and ex12's COO Jacobian), each case's
dof layout equal to the reference's (build_dof_layout's and
build_edges' numbering, dof coordinates) and its residual and Jacobian
at seeded inputs to 1e-12 relative, then the case's own check (a
convergence rate, a patch test, symmetry) on the port (a convergence
study holds its coarser mesh to the reference); plus the DS Jacobian
against a finite difference of the DS residual, and the vectorised
numbering against the reference's loops on larger meshes.

User pointwise functions are written once against an array module m
(jax.numpy or torch), out of place."""

import math

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import petsc_tpu.dm.fe as R
import petsc_tpu_torch.dm.fe as T
import petsc_tpu_torch as pt
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex
from tests.plex_parity import BOX, dirichlet_solve, eye, fe_pair, host

torch.set_num_threads(1)

# ------------------------------------------------------------ tests/test_fe.py

def test_quadrature_exactness():
    for mod in (T, R):
        qp, qw = mod.gauss_quadrature(2, 2)
        assert np.isclose((qw * qp[:, 0] ** 2).sum(), 1.0 / 12.0)
        qp, qw = mod.gauss_quadrature(2, 2, cell="tensor")
        assert np.isclose((qw * qp[:, 0] ** 3 * qp[:, 1] ** 3).sum(), 1.0 / 16)
    for args in ((2, 1), (2, 2), (2, 3), (1, 3), (3, 2, "tensor")):
        a, b = T.gauss_quadrature(*args), R.gauss_quadrature(*args)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _fe_create_poisson(kind, n, ref=True):
    """tests/test_fe.py's _poisson_solve through the port: FE.create's
    element, MatAIJ.zeroRowsColumns, CG + ILU; returns the max nodal error."""
    forms = lambda m: (lambda u, gu, x: -2 * m.pi ** 2 * m.sin(m.pi * x[0])   # noqa: E731
                       * m.sin(m.pi * x[1]), lambda u, gu, x: gu)
    ds, _ = fe_pair((n, n), None, forms, make_fe=lambda mod: mod.FE.create(kind), ref=ref)
    u = np.zeros(ds.ndof)
    A = ds.assembleJacobian(u)
    F = host(ds.assembleResidual(u))
    bdofs = ds.boundary_dofs(lambda x: min(x[0], x[1], 1 - x[0], 1 - x[1]) < 1e-12)
    Am = pt.MatAIJ.from_scipy(A)
    bvec = pt.Vec.from_array(-F)
    Am.zeroRowsColumns(bdofs, diag=1.0, x=pt.Vec.from_array(np.zeros(ds.ndof)), b=bvec)
    ksp = pt.KSP().create()
    ksp.setOperators(Am)
    ksp.setType("cg")
    ksp.getPC().setType("ilu")
    ksp.setTolerances(rtol=1e-12)
    sol = Am.createVecRight()
    ksp.solve(bvec, sol)
    assert ksp.getConvergedReason().converged
    xs = ds.dof_coords
    return np.max(np.abs(host(sol)[: ds.ndof] - np.sin(np.pi * xs[:, 0]) * np.sin(np.pi * xs[:, 1])))


def test_fe_create_p1_p2_q1_tables():
    for kind in ("p1", "p2", "q1"):
        a, b = T.FE.create(kind), R.FE.create(kind)
        assert a.nb == b.nb and a.dof_kind == b.dof_kind
        assert np.array_equal(a.B, b.B) and np.array_equal(a.D, b.D)


def test_p1_poisson_converges_order2():
    e1, e2 = _fe_create_poisson("p1", 8), _fe_create_poisson("p1", 16, ref=False)
    assert 1.7 < np.log2(e1 / e2) < 2.4, (e1, e2)


def test_p2_poisson_much_more_accurate():
    assert _fe_create_poisson("p2", 8) < 0.1 * _fe_create_poisson("p1", 8, ref=False)


def test_nonlinear_form_jacobian_against_a_finite_difference():
    """The element Jacobian of a nonlinear reaction term against a finite
    difference of the residual (P1 and P2), and the reference's."""
    for mk in (lambda mod: mod.FE.create("p1"), lambda mod: mod.lagrange_fe(2, 2)):
        ds, _ = fe_pair((3, 3), None, lambda m: (lambda u, gu, x: u ** 3 - 1.0 + x[0] * u,
                                               lambda u, gu, x: (1.0 + u * u) * gu), make_fe=mk)
        rng = np.random.default_rng(0)
        u = rng.random(ds.ndof)
        A = ds.assembleJacobian(u).toarray()
        F0 = host(ds.assembleResidual(u))
        h = 1e-7
        for j in rng.choice(ds.ndof, 5, replace=False):
            up = u.copy()
            up[j] += h
            fd = (host(ds.assembleResidual(up)) - F0) / h
            assert np.allclose(A[:, j], fd, atol=1e-5)


# ------------------------------------------------------------ tests/test_fe_lagrange.py

def test_stroud_quadrature_exactness():
    for deg in (1, 3, 5):
        qp, qw = T.stroud_conical_quadrature(2, deg)
        rq = R.stroud_conical_quadrature(2, deg)
        assert np.array_equal(qp, rq[0]) and np.array_equal(qw, rq[1])
        for a in range(deg + 1):
            for b in range(deg + 1 - a):
                exact = math.factorial(a) * math.factorial(b) / math.factorial(a + b + 2)
                assert abs(float((qw * qp[:, 0] ** a * qp[:, 1] ** b).sum()) - exact) < 1e-13
    qp, qw = T.stroud_conical_quadrature(3, 4)
    assert abs(qw.sum() - 1 / 6) < 1e-13 and abs(float((qw * qp[:, 0]).sum()) - 1 / 24) < 1e-13
    qp, qw = T.prism_quadrature(3)
    rq = R.prism_quadrature(3)
    assert np.array_equal(qp, rq[0]) and np.array_equal(qw, rq[1]) and abs(qw.sum() - 0.5) < 1e-13


@pytest.mark.parametrize("dim,k,cell", [
    (2, 1, "simplex"), (2, 2, "simplex"), (2, 3, "simplex"), (2, 4, "simplex"),
    (3, 1, "simplex"), (3, 2, "simplex"), (3, 3, "simplex"), (2, 1, "tensor"),
    (2, 2, "tensor"), (3, 1, "tensor"), (3, 2, "prism")])
def test_lagrange_tables_equal_the_reference(dim, k, cell):
    fe, fr = T.lagrange_fe(dim, k, cell), R.lagrange_fe(dim, k, cell)
    for key in ("B", "D", "qp", "qw", "nodes"):
        assert np.array_equal(getattr(fe, key), getattr(fr, key)), key
    assert fe.node_kinds == fr.node_kinds and fe.name == fr.name
    assert np.allclose(fe.B.sum(axis=1), 1.0, atol=1e-11)
    assert np.allclose(fe.D.sum(axis=1), 0.0, atol=1e-10)


def _poisson_forms(dim):
    def forms(m):
        w = math.pi

        def f(x):
            out = (2 if dim == 2 else 3) * w * w * m.sin(w * x[0]) * m.sin(w * x[1])
            return out * m.sin(w * x[2]) if dim == 3 else out
        return (lambda u, gu, x: -f(x)), (lambda u, gu, x: gu)
    return forms


def _poisson_error(fe_args, faces, simplex, ref=True):
    dim = fe_args[0]
    ds, _ = fe_pair(faces, fe_args, _poisson_forms(dim), simplex=simplex, ref=ref)
    u = dirichlet_solve(ds, ds.boundary_dofs(BOX))
    X = ds.dof_coords
    uex = np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])
    if dim == 3:
        uex = uex * np.sin(np.pi * X[:, 2])
    return float(np.abs(u - uex).max())


@pytest.mark.parametrize("fe_args,simplex,order", [
    ((2, 1), True, 2.0), ((2, 2), True, 3.0), ((2, 3), True, 4.0),
    ((2, 2, "tensor"), False, 3.0)])
def test_poisson_convergence_2d(fe_args, simplex, order):
    e1 = _poisson_error(fe_args, (6, 6), simplex)
    e2 = _poisson_error(fe_args, (12, 12), simplex, ref=False)
    assert np.log2(e1 / e2) > order - 0.6, (fe_args, e1, e2)


@pytest.mark.parametrize("fe_args,simplex,order", [((3, 2), True, 3.0),
                                                   ((3, 1, "tensor"), False, 2.0)])
def test_poisson_convergence_3d(fe_args, simplex, order):
    e1 = _poisson_error(fe_args, (2, 2, 2), simplex)
    e2 = _poisson_error(fe_args, (4, 4, 4), simplex, ref=False)
    assert np.log2(e1 / e2) > order - 0.7, (fe_args, e1, e2)


def test_vector_elasticity_p2():
    """2-D linear elasticity (ncomp 2, node-major dofs) with a manufactured
    solution: the reference's operator, symmetric, and the solution near
    the exact one."""
    mu = lam = 1.0

    def forms(m):
        def f1(u_, gu, x):
            e = 0.5 * (gu + gu.T)
            return 2 * mu * e + lam * (e[0, 0] + e[1, 1]) * eye(m, 2)

        def f_body(x):
            u = m.sin(m.pi * x[0]) * m.sin(m.pi * x[1])
            uxx = uyy = -m.pi ** 2 * u
            uxy = m.pi ** 2 * m.cos(m.pi * x[0]) * m.cos(m.pi * x[1])
            return m.stack([-((2 * mu + lam) * uxx + mu * uyy), -((mu + lam) * uxy)])
        return (lambda u_, gu, x: -f_body(x)), f1

    ds, _ = fe_pair((8, 8), (2, 2), forms, fe_kw={"ncomp": 2})
    J = ds.assembleJacobian(np.zeros(ds.ndof))
    assert abs(J - J.T).max() < 1e-10
    u = dirichlet_solve(ds, ds.boundary_dofs(BOX))
    X = ds.dof_coords
    uex = np.zeros(ds.ndof)
    uex[0::2] = np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])
    assert np.abs(u - uex).max() < 3e-3
    assert np.array_equal(ds.boundary_dofs(BOX, comp=1), fe_pair((8, 8), (2, 2), fe_kw={
        "ncomp": 2})[1].boundary_dofs(BOX, comp=1))


def test_p3_edge_orientation_continuity():
    ds, _ = fe_pair((3, 3), (2, 3), lambda m: (None, lambda u_, gu, x: gu))
    J = ds.assembleJacobian(np.random.default_rng(0).random(ds.ndof))
    assert abs(J - J.T).max() < 1e-10
    X = ds.dof_coords
    F = host(ds.assembleResidual(X[:, 0] ** 3 - 3 * X[:, 0] * X[:, 1] ** 2))
    keep = np.ones(ds.ndof, bool)
    keep[ds.boundary_dofs(BOX)] = False
    assert np.abs(F[keep]).max() < 1e-10


def test_p4_tet_supported():
    fe = T.lagrange_fe(3, 4)
    assert fe.nb == 35 and sum(1 for kk in fe.node_kinds if kk[0] == "face") == 12


def test_crouzeix_raviart_poisson():
    fe = T.crouzeix_raviart_fe()
    assert np.allclose(fe.B.sum(axis=1), 1.0)
    assert np.array_equal(fe.B, R.crouzeix_raviart_fe().B)

    def err(n):
        ds, _ = fe_pair((n, n), None, _poisson_forms(2), make_fe=lambda mod: mod.crouzeix_raviart_fe(),
                      ref=n == 8)
        u = dirichlet_solve(ds, ds.boundary_dofs(BOX))
        X = ds.dof_coords
        return np.sqrt(np.mean((u - np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])) ** 2))

    assert np.log2(err(8) / err(16)) > 1.5


def test_p0disc_and_vector_cr_layouts():
    fe_pair((4, 3), None, lambda m: (lambda u, gu, x: u * u, None),
          make_fe=lambda mod: mod.p0disc_fe(2))
    def vcr(mod):
        fe = mod.crouzeix_raviart_fe()
        fe.ncomp = 2
        return fe
    fe_pair((4, 3), None, lambda m: (None, lambda u, gu, x: (1 + u[0] ** 2) * gu), make_fe=vcr)


@pytest.mark.parametrize("faces,fe_args,simplex", [
    ((24, 24), (2, 2), True), ((16, 16), (2, 3), True), ((5, 5, 5), (3, 2), True),
    ((4, 4, 4), (3, 3), True), ((8, 8), (2, 3, "tensor"), False),
    ((3, 3, 3), (3, 2, "tensor"), False), ((4, 4, 4), (3, 4), True)])
def test_dof_layout_numbering_equals_the_reference(faces, fe_args, simplex):
    """build_dof_layout (vectorised) and build_edges give the reference's
    conn, dof count and dof coordinates."""
    p, r = DMPlex.createBoxMesh(faces, simplex=simplex), RPlex.createBoxMesh(faces, simplex=simplex)
    fe, fr = T.lagrange_fe(*fe_args), R.lagrange_fe(*fe_args)
    a, b = T.build_dof_layout(p.cells, p.coords, fe), R.build_dof_layout(r.cells, r.coords, fr)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1] and np.array_equal(a[2], b[2])
    if p.cells.shape[1] == 3:
        e, c = T.build_edges(p.cells), R.build_edges(r.cells)
        assert np.array_equal(e[0], c[0]) and np.array_equal(e[1], c[1])


def test_prism_layout_and_prism_poisson():
    def mesh(P):
        return P.createBoxMesh((3, 3)).extrudeToPrisms(2, 1.0)
    for k in (1, 2):
        ds, _ = fe_pair(None, (3, k), _poisson_forms(3), mesh=mesh, fe_kw={"cell": "prism"})
    assert ds.ndof > 0


# ------------------------------------------------------------ tests/test_fe_p4_3d.py

@pytest.mark.parametrize("k,cell", [(4, "simplex"), (5, "simplex"), (3, "tensor"), (4, "tensor")])
def test_p4plus_and_q3plus_3d_conforming_patch(k, cell):
    simplex = cell == "simplex"
    ds, _ = fe_pair((2, 2, 2), (3, k), lambda m: (None, lambda u_, gu, x: gu), simplex=simplex,
                  fe_kw={"cell": cell}, check=False)
    assert ds.ndof == (2 * k + 1) ** 3
    u = ds.dof_coords[:, 0] ** k
    assert ds.l2_error(u, lambda x: x[0] ** k) < (1e-11 if simplex else 1e-9)
    S = ds.assembleJacobian(np.zeros(ds.ndof)).tocsr()
    keep = np.ones(ds.ndof, bool)
    keep[ds.boundary_dofs(BOX)] = False
    X = ds.dof_coords
    uex = X[:, 0] ** 2 + 2 * X[:, 1] ** 2 - 3 * X[:, 2] ** 2
    assert np.abs((S @ uex)[keep]).max() < (1e-10 if simplex else 1e-8)
    u2 = uex.copy()
    u2[keep] = spla.spsolve(S[keep][:, keep].tocsc(), -(S[keep][:, ~keep] @ uex[~keep]))
    assert np.abs(u2 - uex).max() < (1e-9 if simplex else 1e-7)


def test_p4_tet_operator_equals_the_reference():
    fe_pair((2, 2, 2), (3, 4), lambda m: (lambda u, gu, x: u * x[2], lambda u_, gu, x: gu))


