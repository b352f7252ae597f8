"""The port's DMPlexTransform family and DMAdaptLabel/DMAdaptMetric
(petsc_tpu_torch/dm/plex_transform.py) against the JAX package's on the
CPU: every case of tests/test_plex_transform.py with the transformed mesh,
its parent map, labels and recorded interpolation equal to the
reference's, and the adapted meshes' assemblies, solves and PCMG
hierarchy as the reference's.

Tolerances (tests/plex_parity.py): meshes, numbering and interpolations
equal; assembled operators to 1e-12 relative; solutions to 1e-8
relative."""

from collections import Counter

import numpy as np
import pytest
import torch

import petsc_tpu as pj
import petsc_tpu_torch as pt
import petsc_tpu.dm.plex_transform as R
import petsc_tpu_torch.dm.plex_transform as T
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex
from tests.plex_parity import U_RTOL, assert_close, assert_same_mesh, host, init

torch.set_num_threads(1)

TRI_EDGES = [(0, 1), (1, 2), (2, 0)]
TET_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _both(faces, simplex=True):
    return DMPlex.createBoxMesh(faces, simplex=simplex), RPlex.createBoxMesh(faces, simplex=simplex)


def _same(q, qr):
    """The transformed plex equals the reference's: cells, coordinates,
    parent map, labels, interpolation."""
    assert_same_mesh(q, qr)
    assert np.array_equal(q.parent_cells, qr.parent_cells)
    assert (q._interp != qr._interp).nnz == 0
    assert set(getattr(q, "labels", {}) or {}) == set(getattr(qr, "labels", {}) or {})
    for k in getattr(q, "labels", {}) or {}:
        assert np.array_equal(q.labels[k], qr.labels[k])
    assert np.allclose(np.asarray(q._interp.sum(axis=1)).ravel(), 1.0)


def _tri_area(coords, cells):
    v = coords[cells]
    return 0.5 * np.abs((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
                        - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))


def _tet_vol(coords, cells):
    v = coords[cells]
    return np.abs(np.linalg.det(np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                                          v[:, 3] - v[:, 0]], axis=1))) / 6.0


def _conforming(cells, facets):
    cnt = Counter()
    for cell in cells:
        for f in facets:
            cnt[tuple(sorted(int(cell[v]) for v in f))] += 1
    assert set(cnt.values()) <= {1, 2}


@pytest.mark.parametrize("name,faces,simplex", [
    ("alfeld_split", (3, 3), True), ("alfeld_split", (2, 2, 2), True),
    ("to_box", (3, 2), True), ("to_box", (2, 2, 2), True),
    ("to_simplex", (3, 3), False), ("to_simplex", (2, 2, 2), False)])
def test_transforms_equal_the_reference(name, faces, simplex):
    p, r = _both(faces, simplex)
    p.labels = {"zone": np.array([0, 1])}
    r.labels = {"zone": np.array([0, 1])}
    q, qr = getattr(T, name)(p), getattr(R, name)(r)
    _same(q, qr)
    if name == "alfeld_split":
        assert q.ncells == (3 if p.dim == 2 else 4) * p.ncells
        assert len(q.labels["zone"]) == (6 if p.dim == 2 else 8)
    if q.cells.shape[1] == 3:
        assert np.isclose(_tri_area(q.coords, q.cells).sum(), 1.0)
        _conforming(q.cells, TRI_EDGES)
    if q.cells.shape[1] == 4 and q.dim == 3:
        vol = _tet_vol(q.coords, q.cells)
        assert np.isclose(vol.sum(), 1.0)


def test_refine_1d():
    cells, coords = [[0, 1], [1, 2]], [[0.0], [0.5], [1.0]]
    q = T.refine_1d(DMPlex.createFromCellList(1, cells, coords))
    _same(q, R.refine_1d(RPlex.createFromCellList(1, cells, coords)))
    assert q.ncells == 4 and np.isclose(np.sort(q.coords.ravel())[1], 0.25)


@pytest.mark.parametrize("marked", [np.array([0, 5]), np.array([3, 7, 11, 12, 30])])
def test_adapt_label_triangles(marked):
    p, r = _both((4, 4))
    q, qr = T.adapt_label(p, marked), R.adapt_label(r, marked)
    _same(q, qr)
    _conforming(q.cells, TRI_EDGES)
    assert np.isclose(_tri_area(q.coords, q.cells).sum(), 1.0)
    for m in marked:
        assert (q.parent_cells == m).sum() == 4
    assert p.ncells < q.ncells < 4 * p.ncells


def test_adapt_label_via_dmlabel_and_solve():
    """adaptLabel with a DMLabel (value None: every stratum but KEEP and
    COARSEN; an explicit value: that stratum), then CG on the adapted
    mesh's Poisson operator as the reference's."""
    from petsc_tpu.dm.label import DMLabel as RLabel
    from petsc_tpu_torch.dm.label import DMLabel
    init()
    p, r = _both((4, 4))
    lbl, lr = DMLabel("adapt"), RLabel("adapt")
    for L in (lbl, lr):
        L.insertIS(np.array([3, 7, 11]), T.DM_ADAPT_REFINE)
        L.insertIS(np.array([1]), T.DM_ADAPT_COARSEN)
        L.insertIS(np.array([20]), 5)
    q, qr = p.adaptLabel(lbl), r.adaptLabel(lr)
    _same(q, qr)
    _same(p.adaptLabel(lbl, value=5), r.adaptLabel(lr, value=5))
    (A, b), (Ar, br) = q.assemblePoissonP1(f=1.0), qr.assemblePoissonP1(f=1.0)
    assert_close(A, Ar)
    ksp = pt.KSP().create()
    ksp.setType("cg")
    ksp.setOperators(A)
    ksp.setTolerances(rtol=1e-10)
    x = b.duplicate()
    ksp.solve(b, x)
    kr = pj.KSP().setType("cg").setOperators(Ar).setTolerances(rtol=1e-10)
    xr = br.duplicate()
    kr.solve(br, xr)
    assert ksp.getIterationNumber() == kr.getIterationNumber() > 0
    xs, xrs = host(x)[: q.nvertices], np.asarray(xr.getArray())[: q.nvertices]
    assert np.linalg.norm(xs - xrs) <= U_RTOL * np.linalg.norm(xrs) and xs.max() > 0


@pytest.mark.parametrize("marked", [np.array([0, 7, 20]), np.arange(6)])
def test_adapt_label_tets(marked):
    p, r = _both((2, 2, 2))
    q, qr = T.adapt_label(p, marked), R.adapt_label(r, marked)
    _same(q, qr)
    _conforming(q.cells, TET_FACES)
    assert np.isclose(_tet_vol(q.coords, q.cells).sum(), 1.0)
    assert _tet_vol(q.coords, q.cells).min() > 1e-12
    for m in marked:
        assert (q.parent_cells == m).sum() >= 2
    q2, qr2 = T.adapt_label(q, np.arange(0, q.ncells, 3)), R.adapt_label(qr, np.arange(0, qr.ncells, 3))
    _same(q2, qr2)
    _conforming(q2.cells, TET_FACES)


def test_adapt_label_tets_repeated_and_solve():
    """Two adaptation rounds, then the P1 DS's Jacobian and residual on the
    result (the port's assembly against the reference's) and a direct solve."""
    import scipy.sparse.linalg as spla
    from petsc_tpu.dm.fe import DS as RDS
    from petsc_tpu.dm.fe import lagrange_fe as rlag
    from petsc_tpu_torch.dm.fe import DS, lagrange_fe
    init()
    p, r = _both((2, 2, 2))
    q = T.adapt_label(T.adapt_label(p, np.arange(6)), np.arange(0, 40, 3))
    qr = R.adapt_label(R.adapt_label(r, np.arange(6)), np.arange(0, 40, 3))
    _same(q, qr)
    ds, dr = DS(q, lagrange_fe(3, 1)), RDS(qr, rlag(3, 1))
    ds.setResidual(f0=lambda u, gu, x: -1.0, f1=lambda u, gu, x: gu)
    dr.setResidual(f0=lambda u, gu, x: -1.0, f1=lambda u, gu, x: gu)
    z = np.zeros(ds.ndof)
    J, Jr = ds.assembleJacobian(z), dr.assembleJacobian(z)
    F, Fr = host(ds.assembleResidual(z)), np.asarray(dr.assembleResidual(z))
    assert_close(J, Jr)
    assert_close(F, Fr)
    bnd = ds.boundary_dofs(lambda x: x.min() < 1e-9 or x.max() > 1 - 1e-9)
    keep = np.ones(ds.ndof, bool)
    keep[bnd] = False
    u = spla.spsolve(J[keep][:, keep].tocsc(), -F[keep])
    assert np.isfinite(u).all() and u.max() > 0


def test_adapt_metric_cases():
    """Scalar metric on tets, isotropic field on triangles, an anisotropic
    tensor field: the reference's meshes and convergence flags."""
    p3, r3 = _both((2, 2, 2))
    h = np.where(np.linalg.norm(p3.coords, axis=1) < 0.5, 0.15, 1.0)
    q, qr = T.adapt_metric(p3, h, max_passes=8), R.adapt_metric(r3, h, max_passes=8)
    assert_same_mesh(q, qr)
    assert q.metric_converged == qr.metric_converged
    _conforming(q.cells, TET_FACES)
    p, r = _both((4, 4))
    h2 = np.where(np.linalg.norm(p.coords, axis=1) < 0.4, 0.08, 0.5)
    q, qr = T.adapt_metric(p, h2, max_passes=4), R.adapt_metric(r, h2, max_passes=4)
    assert_same_mesh(q, qr)
    cc = q.coords[q.cells].mean(axis=1)
    assert (np.linalg.norm(cc, axis=1) < 0.4).sum() > 3 * (
        np.linalg.norm(cc - 1.0, axis=1) < 0.4).sum()
    M = np.zeros((p.nvertices, 2, 2))
    M[:, 0, 0], M[:, 1, 1] = 16.0 ** 2, 4.0 ** 2
    q, qr = T.adapt_metric(p, M, max_passes=5), R.adapt_metric(r, M, max_passes=5)
    assert_same_mesh(q, qr)
    e01 = q.coords[q.cells[:, 1]] - q.coords[q.cells[:, 0]]
    assert (16.0 ** 2 * e01[:, 0] ** 2 + 4.0 ** 2 * e01[:, 1] ** 2).max() <= 2.0 + 1e-12
    q = p.adaptMetric(0.3)
    assert_same_mesh(q, r.adaptMetric(0.3))


def test_plextransform_object_api():
    p, r = _both((2, 2))
    t = T.PlexTransform("refine_alfeld")
    assert t.getType() == "refine_alfeld"
    assert_same_mesh(t.apply(p), R.PlexTransform("refine_alfeld").apply(r))
    for name, opts in (("refine_regular", {}), ("refine_tobox", {}), ("extrude", {"layers": 2}),
                       ("transform_filter", {"cells": np.arange(4)}),
                       ("refine_sbr", {"active": np.array([1, 2])})):
        assert_same_mesh(p.transform(name, **opts), r.transform(name, **opts))
    assert p.transform("transform_filter", cells=np.arange(4)).ncells == 4
    assert set(T.PlexTransform.TYPES) == set(R.PlexTransform.TYPES)
    with pytest.raises(pt.Error):
        T.PlexTransform("not_a_type")


def test_pcmg_on_adapted_hierarchy():
    """createInterpolation on an adaptLabel-refined plex: the reference's
    operator, exact on linear functions through the port's MatAIJ (S2)."""
    init()
    p, r = _both((4, 4))
    q, qr = p.adaptLabel(np.arange(8)), r.adaptLabel(np.arange(8))
    I, Ir = q.createInterpolation(p), qr.createInterpolation(r)
    assert I.getSize() == (q.nvertices, p.nvertices)
    assert_close(I, Ir)
    v = pt.Vec.from_array(p.coords.sum(axis=1))
    w = pt.Vec.from_array(np.zeros(q.nvertices))
    I.mult(v, w)
    assert np.allclose(host(w), q.coords.sum(axis=1), atol=1e-12)
