"""The port's DMPlex (petsc_tpu_torch/dm/plex.py, label.py, plex_exodus.py)
against the JAX package's on the CPU: tests/test_plex.py's topology,
boundary, Gmsh, interpolation, section, label, submesh and extrusion
cases, tests/test_plex_refine.py's refinement and geometric multigrid
(all but the sharded case, which waits for ROADMAP queue 1 item 12) and
tests/test_plex_exodus.py's round trips, plus refine's numbering equal to
the reference's, an Exodus file written by each package read by the
other, and the distribution and HDF5 entry points raising the port's
Error with their item.

Tolerances (tests/plex_parity.py): meshes, numbering and interpolations
equal; assembled operators to 1e-12 relative; iterations and reasons
equal, histories to 1e-6 relative, solutions to 1e-8 relative."""

import numpy as np
import pytest
import torch

import petsc_tpu as pj
import petsc_tpu_torch as pt
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu.dm.plex import Section as RSection
from petsc_tpu_torch.dm.label import DMLabel
from petsc_tpu_torch.dm.plex import DMPlex, PetscPartitioner, PlexDistribution, Section
from tests.plex_parity import (U_RTOL, assert_close, assert_history, assert_same_mesh, host,
                               init)

torch.set_num_threads(1)

GMSH22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
3
1 1 2 7 1 1 2
2 2 2 5 1 1 2 3
3 2 2 5 1 1 3 4
$EndElements
"""

GMSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
0 0 1 0
1 0 0 0 1 1 0 1 7 0
$EndEntities
$Nodes
1 4 1 4
2 1 0 4
1
2
3
4
0 0 0
1 0 0
1 1 0
0 1 0
$EndNodes
$Elements
1 2 1 2
2 1 2 2
1 1 2 3
2 1 3 4
$EndElements
"""

GMSH_SQUARE = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
5 0.45 0.55 0
$EndNodes
$Elements
4
1 2 2 5 1 1 2 5
2 2 2 5 1 2 3 5
3 2 2 5 1 3 4 5
4 2 2 5 1 4 1 5
$EndElements
"""


def _solve(pk, A, b, ksp_type, pc_type, rtol, max_it=500, args=()):
    ksp = pk.KSP().create()
    ksp.setOperators(A)
    ksp.setType(ksp_type)
    ksp.getPC().setType(pc_type)
    if args:
        ksp.getPC().setFromOptions()
    ksp.setTolerances(rtol=rtol, max_it=max_it)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp, x


def _same_solve(port, ref, n):
    (kp, xp), (kr, xr) = port, ref
    assert kp.getIterationNumber() == kr.getIterationNumber()
    assert int(kp.getConvergedReason()) == int(kr.getConvergedReason())
    assert kp.getConvergedReason().converged
    assert_history(kp.getConvergenceHistory(), kr.getConvergenceHistory())
    up, ur = host(xp)[:n], np.asarray(xr.getArray())[:n]
    assert np.linalg.norm(up - ur) <= U_RTOL * np.linalg.norm(ur)
    return up


# ------------------------------------------------------------ tests/test_plex.py

def test_chart_and_cone():
    init()
    p, r = DMPlex.createBoxMesh((2, 2), simplex=True), RPlex.createBoxMesh((2, 2), simplex=True)
    assert_same_mesh(p, r)
    assert p.ncells == 8 and p.nvertices == 9
    assert p.getChart() == r.getChart() == (0, 17)
    assert np.array_equal(p.getCone(0), r.getCone(0)) and (p.getCone(0) >= p.ncells).all()
    assert np.array_equal(p.getSupport(p.ncells), r.getSupport(r.ncells))
    assert np.array_equal(p.getConeClosure(3), r.getConeClosure(3))
    assert p.getHeightStratum(0) == r.getHeightStratum(0)
    assert p.getHeightStratum(2) == r.getHeightStratum(2)


@pytest.mark.parametrize("faces,simplex", [((3, 3), True), ((3, 2), False), ((2, 2, 2), True),
                                           ((2, 2, 1), False)])
def test_boundary_vertices(faces, simplex):
    p, r = DMPlex.createBoxMesh(faces, simplex=simplex), RPlex.createBoxMesh(faces, simplex=simplex)
    assert_same_mesh(p, r)
    bnd = p.markBoundaryVertices()
    assert np.array_equal(bnd, r.markBoundaryVertices())
    on_edge = ((p.coords[bnd] == 0.0) | (p.coords[bnd] == 1.0)).any(axis=1)
    assert on_edge.all()
    if faces == (3, 3):
        assert len(bnd) == 12


@pytest.mark.parametrize("n", [8, 16])
def test_p1_poisson_2d_gamg(n):
    """-Lap u = 1 on the unit square by CG + GAMG: the assembled operator,
    the right-hand side, iterations, history and solution the reference's;
    the centre value near the series solution 0.07367."""
    init()
    p, r = DMPlex.createBoxMesh((n, n), simplex=True), RPlex.createBoxMesh((n, n), simplex=True)
    (A, b), (Ar, br) = p.assemblePoissonP1(f=1.0), r.assemblePoissonP1(f=1.0)
    assert_close(A, Ar)
    assert_close(b, np.asarray(br.getArray())[: p.nvertices])
    u = _same_solve(_solve(pt, A, b, "cg", "gamg", 1e-10, 200),
                    _solve(pj, Ar, br, "cg", "gamg", 1e-10, 200), p.nvertices)
    center = np.argmin(np.sum((p.coords - 0.5) ** 2, axis=1))
    assert abs(u[center] - 0.07367135) < (1e-2 if n == 8 else 2e-3)


def test_p1_poisson_3d():
    init()
    p, r = DMPlex.createBoxMesh((4, 4, 4), simplex=True), RPlex.createBoxMesh((4, 4, 4))
    assert p.cells.shape[1] == 4
    (A, b), (Ar, br) = p.assemblePoissonP1(f=1.0), r.assemblePoissonP1(f=1.0)
    assert_close(A, Ar)
    u = _same_solve(_solve(pt, A, b, "cg", "jacobi", 1e-10),
                    _solve(pj, Ar, br, "cg", "jacobi", 1e-10), p.nvertices)
    assert u.max() > 0.02 and u.min() >= -1e-12


def test_poisson_dirichlet_callable_and_array():
    """assemblePoissonP1's Dirichlet data as a callable and as a per-vertex
    array: the lifted right-hand side and the operator the reference's."""
    init()
    p, r = DMPlex.createBoxMesh((5, 4)), RPlex.createBoxMesh((5, 4))
    g = lambda x: 1.0 + x[0] - 2.0 * x[1]   # noqa: E731
    for dv in (g, p.coords[:, 0] ** 2):
        (A, b), (Ar, br) = p.assemblePoissonP1(f=0.5, dirichlet_value=dv), \
            r.assemblePoissonP1(f=0.5, dirichlet_value=dv)
        assert_close(A, Ar)
        assert_close(b, np.asarray(br.getArray())[: p.nvertices])


@pytest.mark.parametrize("text,label", [(GMSH22, "physical_5"), (GMSH41, "physical_7")])
def test_gmsh_readers(tmp_path, text, label):
    """Gmsh ASCII v2.2 and v4.1 (plexgmsh.c): the reference's mesh and
    labels, and the mesh assembles."""
    init()
    path = tmp_path / "m.msh"
    path.write_text(text)
    p, r = DMPlex.createFromGmsh(str(path)), RPlex.createFromGmsh(str(path))
    assert_same_mesh(p, r)
    assert set(p.labels) == set(r.labels) == {label}
    assert np.array_equal(p.labels[label], r.labels[label]) and len(p.labels[label]) == 2
    g, vol = p.p1_gradients()
    gr, volr = r.p1_gradients()
    assert np.allclose(g, gr, rtol=0, atol=1e-15) and abs(vol.sum() - 1.0) < 1e-12
    A, _ = p.assemblePoissonP1()
    assert A.getSize() == (4, 4)


def test_plex_interpolate_edges():
    p, r = DMPlex.createBoxMesh((4, 4)).interpolate(), RPlex.createBoxMesh((4, 4)).interpolate()
    assert np.array_equal(p.edges, r.edges) and np.array_equal(p.cell2edge, r.cell2edge)
    assert p.nvertices - len(p.edges) + p.ncells == 1
    assert p.getDepth() == 2
    cone = p.getConeInterpolated(0)
    assert np.array_equal(cone, r.getConeInterpolated(0)) and len(cone) == 3
    assert np.array_equal(p.getEdgeCone(cone[0]), r.getEdgeCone(cone[0]))


def test_interpolate_3d_tet_strata():
    p = DMPlex.createBoxMesh((2, 2, 2), simplex=True).interpolate()
    r = RPlex.createBoxMesh((2, 2, 2), simplex=True).interpolate()
    for k in ("edges", "cell2edge", "faces", "cell2face", "face2edge"):
        assert np.array_equal(getattr(p, k), getattr(r, k)), k
    assert p.getDepth() == 3
    V, E, F, C = p.nvertices, len(p.edges), len(p.faces), p.ncells
    assert V - E + F - C == 1
    fcone = p.getConeInterpolated(0)
    econe = p.getFaceCone(int(fcone[0]))
    assert len(fcone) == 4 and len(econe) == 3
    assert len(p.getEdgeCone(int(econe[0]))) == 2


def test_section_fields_constraints():
    for S in (Section, RSection):
        s = S(5)
        s.setNumFields(2)
        for q in range(5):
            s.setFieldDof(q, 0, 2)
            s.setFieldDof(q, 1, 1)
            s.setDof(q, 3)
        s.setConstraintDof(0, 1)
        s.setUp()
        assert s.getStorageSize() == 15 and s.getConstrainedStorageSize() == 14
        assert s.getOffset(2) == 6 and s.getFieldOffset(2, 1) == 8
        assert s.getChart() == (0, 5) and s.getNumFields() == 2
        assert s.getFieldDof(3, 0) == 2 and s.getConstraintDof(0) == 1


def test_plex_vectors_and_section():
    init()
    p = DMPlex.createBoxMesh((3, 3))
    s = p.createSection(dof_per_vertex=2)
    assert s.getStorageSize() == 2 * p.nvertices == p.N
    v = p.createGlobalVector()
    assert v.getSize() == p.N and v._dm is p
    A = p.createMatrix()
    assert A.getSize() == (p.N, p.N) and A._dm is p


def test_plex_getlabel_and_submesh():
    init()
    p, r = DMPlex.createBoxMesh((6, 6)), RPlex.createBoxMesh((6, 6))
    cent = p.coords[p.cells].mean(axis=1)
    left = np.nonzero(cent[:, 0] < 0.5)[0]
    p.labels = {"physical_3": left}
    r.labels = {"physical_3": left}
    lbl = p.getLabel("physical")
    assert isinstance(lbl, DMLabel)
    assert lbl.getStratumSize(3) == len(left)
    assert np.array_equal(lbl.getStratumIS(3), np.sort(left))
    assert np.array_equal(lbl.getValueIS(), r.getLabel("physical").getValueIS())
    sub, subr = p.createSubmesh(left), r.createSubmesh(left)
    assert_same_mesh(sub, subr)
    assert np.array_equal(sub.parent_vertices, subr.parent_vertices)
    assert np.allclose(sub.coords, p.coords[sub.parent_vertices])
    (A, b), (Ar, br) = sub.assemblePoissonP1(), subr.assemblePoissonP1()
    _same_solve(_solve(pt, A, b, "cg", "jacobi", 1e-10),
                _solve(pj, Ar, br, "cg", "jacobi", 1e-10), sub.nvertices)


def test_plex_getlabel_value_semantics():
    p = DMPlex.createBoxMesh((4, 4))
    p.labels = {"physical_7": np.array([0, 1, 2]), "zone": np.array([4])}
    assert p.getLabel("physical_7").getStratumSize(7) == 3
    assert p.getLabel("physical").getStratumSize(7) == 3
    assert p.getLabel("zone").getStratumSize(1) == 1
    assert p.getLabel("nope") is None


def test_dmlabel_surface():
    for L in (DMLabel, __import__("petsc_tpu.dm.label", fromlist=["DMLabel"]).DMLabel):
        lbl = L("m")
        lbl.setValue(3, 2)
        lbl.insertIS([5, 7, 9], 4)
        lbl.setValue(5, 2)
        assert lbl.getValue(5) == 2 and lbl.getValue(1) == -1
        assert list(lbl.getStratumIS(2)) == [3, 5] and lbl.getNumValues() == 2
        lbl.clearValue(3)
        assert not lbl.stratumHasPoint(2, 3) and lbl.stratumHasPoint(4, 9)


def test_dmsliced_and_dmproduct():
    from petsc_tpu_torch.dm.label import DMProduct, DMSliced
    init()
    d = DMSliced.create(3, 4)
    assert d.N == 12 and d.createGlobalVector().getSize() == 12
    prod = DMProduct()
    prod.setDM(1, d)
    assert prod.getDM(1) is d and prod.getDM(0) is None


def test_plex_extrude_conforming_tets():
    init()
    p2, r2 = DMPlex.createBoxMesh((4, 4)), RPlex.createBoxMesh((4, 4))
    p3, r3 = p2.extrude(3, height=0.6), r2.extrude(3, height=0.6)
    assert_same_mesh(p3, r3)
    assert p3.dim == 3 and p3.ncells == p2.ncells * 3 * 3
    v = p3.coords[p3.cells]
    vol = np.abs(np.linalg.det(v[:, 1:] - v[:, :1])) / 6.0
    assert abs(vol.sum() - 0.6) < 1e-12 and vol.min() > 0
    (A, b), (Ar, br) = p3.assemblePoissonP1(), r3.assemblePoissonP1()
    _same_solve(_solve(pt, A, b, "cg", "jacobi", 1e-9),
                _solve(pj, Ar, br, "cg", "jacobi", 1e-9), p3.nvertices)


def test_extrude_to_prisms_and_curve_boundary():
    p, r = DMPlex.createBoxMesh((3, 2)), RPlex.createBoxMesh((3, 2))
    assert_same_mesh(p.extrudeToPrisms(2, 0.5), r.extrudeToPrisms(2, 0.5))
    assert p.extrudeToPrisms(2).markBoundaryVertices().size == \
        r.extrudeToPrisms(2).markBoundaryVertices().size

    def project(x):       # onto the circle of radius 0.5 about the centre
        return 0.5 + 0.5 * (x - 0.5) / np.linalg.norm(x - 0.5)

    p.curveBoundary(project)
    r.curveBoundary(project)
    assert np.array_equal(p.p2_geom[0], r.p2_geom[0])
    assert np.array_equal(p.p2_geom[1], r.p2_geom[1])


def test_partitioner_types():
    p, r = DMPlex.createBoxMesh((6, 6)), RPlex.createBoxMesh((6, 6))
    from petsc_tpu.dm.plex import PetscPartitioner as RPart
    init()
    assert np.array_equal(PetscPartitioner("simple").partition(p, 4),
                          RPart("simple").partition(r, 4))
    part = PetscPartitioner().partition(p, 4)
    assert len(part) == p.ncells and set(part.tolist()) == {0, 1, 2, 3}


def test_distribution_and_hdf5_raise_with_their_item(tmp_path):
    init()
    p = DMPlex.createBoxMesh((3, 3))
    assert p.distribute() is p                 # one shard: the mesh itself
    with pytest.raises(pt.Error, match="item 12"):
        PlexDistribution(p, np.zeros(p.ncells))
    p.distribution = object()
    with pytest.raises(pt.Error, match="item 12"):
        p.assemblePoissonP1()
    p.distribution = None
    # the HDF5 I/O came with item 11b: it raises, naming h5py, only where
    # h5py is missing (tests/test_torch_plex_hdf5.py holds it to the reference)
    import builtins
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *a, **kw)
    builtins.__import__ = no_h5py
    try:
        for call in (lambda: p.viewHDF5(str(tmp_path / "m.h5")),
                     lambda: DMPlex.createFromHDF5(str(tmp_path / "m.h5")),
                     lambda: p.vecViewHDF5(str(tmp_path / "m.h5"), "u", np.zeros(3)),
                     lambda: p.vecLoadHDF5(str(tmp_path / "m.h5"), "u")):
            with pytest.raises(pt.Error, match="h5py"):
                call()
    finally:
        builtins.__import__ = real_import


# ------------------------------------------------------------ tests/test_plex_refine.py

@pytest.mark.parametrize("faces,simplex", [((4, 4), True), ((3, 3), False), ((2, 2, 2), True),
                                           ((2, 2, 2), False), ((5, 3), True)])
def test_refine_numbering_and_geometry(faces, simplex):
    """refine(): the reference's vertex ids, children, coordinates, labels
    and interpolation, twice over; volumes kept, linear functions
    interpolated exactly, coarsen() and createInterpolation."""
    init()
    p, r = DMPlex.createBoxMesh(faces, simplex=simplex), RPlex.createBoxMesh(faces, simplex=simplex)
    p.labels = {"mat": np.asarray([0, 1])}
    r.labels = {"mat": np.asarray([0, 1])}
    f, g = p, r
    for _ in range(2):
        f, g = f.refine(), g.refine()
        assert_same_mesh(f, g)
        assert (f._interp != g._interp).nnz == 0
        assert np.array_equal(f._interp.indices, g._interp.indices)
        assert np.array_equal(f.labels["mat"], g.labels["mat"])
    f1 = p.refine()
    nch = 4 if p.dim == 2 else 8
    assert f1.ncells == p.ncells * nch and len(f1.labels["mat"]) == 2 * nch
    if simplex:
        assert abs(f1.p1_gradients()[1].sum() - p.p1_gradients()[1].sum()) < 1e-12
    lin = p.coords @ np.arange(1, p.dim + 1) + 0.5
    linf = f1.coords @ np.arange(1, p.dim + 1) + 0.5
    assert np.abs(f1._interp @ lin - linf).max() < 1e-12
    assert f1.coarsen() is p
    P = f1.createInterpolation(p)
    assert P.getSize() == (f1.nvertices, p.nvertices)
    assert np.array_equal(P.to_scipy().toarray(), f1._interp.toarray())
    with pytest.raises(pt.Error):
        p.coarsen()
    with pytest.raises(pt.Error):
        f1.createInterpolation(f1)


@pytest.mark.parametrize("source", ["box", "gmsh"])
def test_geometric_mg_on_a_refined_plex(tmp_path, source):
    """CG + PCMG with -pc_mg_levels 4 from a plex refined 3 times (a 4 x 4
    box or an asymmetric Gmsh fan): the reference's levels, iterations,
    history and solution (tests/test_plex_refine.py, the card phase's
    plex_mg_1025 at small size)."""
    init(["-pc_mg_levels", "4"])
    if source == "box":
        p, r = DMPlex.createBoxMesh((4, 4)), RPlex.createBoxMesh((4, 4))
    else:
        path = tmp_path / "sq.msh"
        path.write_text(GMSH_SQUARE)
        p, r = DMPlex.createFromGmsh(str(path)), RPlex.createFromGmsh(str(path))
    for _ in range(3):
        p, r = p.refine(), r.refine()
    (A, b), (Ar, br) = p.assemblePoissonP1(f=1.0), r.assemblePoissonP1(f=1.0)
    port = _solve(pt, A, b, "cg", "mg", 1e-8, 50, args=True)
    ref = _solve(pj, Ar, br, "cg", "mg", 1e-8, 50, args=True)
    _same_solve(port, ref, p.nvertices)
    lv = [lev.A.getSize()[0] for lev in port[0].getPC()._impl.levels]
    assert lv == [lev.A.getSize()[0] for lev in ref[0].getPC()._impl.levels]
    assert len(lv) == 4 and port[0].getIterationNumber() <= 12
    # the Galerkin coarse operators are the reference's
    for lp, lr in zip(port[0].getPC()._impl.levels[1:], ref[0].getPC()._impl.levels[1:]):
        assert_close(lp.A, lr.A)


def test_convergence_under_refinement():
    """P1 Poisson, u = sin(pi x) sin(pi y) with a mass-lumped load: the
    L2 error drops about 4x per refinement (the operator the reference's)."""
    import scipy.sparse.linalg as spla
    init()
    errs = []
    p, r = DMPlex.createBoxMesh((4, 4)), RPlex.createBoxMesh((4, 4))
    for _ in range(3):
        p, r = p.refine(), r.refine()
        _, vol = p.p1_gradients()
        (A, _), (Ar, _) = p.assemblePoissonP1(f=1.0), r.assemblePoissonP1(f=1.0)
        assert_close(A, Ar)
        A_sp = A.to_scipy()
        x, y = p.coords[:, 0], p.coords[:, 1]
        uex = np.sin(np.pi * x) * np.sin(np.pi * y)
        bl = np.zeros(p.nvertices)
        np.add.at(bl, p.cells.reshape(-1), np.repeat(vol / 3.0, 3) * (2 * np.pi ** 2 * uex)[
            p.cells].reshape(-1))
        bl[p.markBoundaryVertices()] = 0.0
        u = spla.spsolve(A_sp.tocsc(), bl)
        lump = np.zeros(p.nvertices)
        np.add.at(lump, p.cells.reshape(-1), np.repeat(vol / 3.0, 3))
        errs.append(np.sqrt(np.sum(lump * (u - uex) ** 2)))
    assert errs[0] / errs[1] > 3.4 and errs[1] / errs[2] > 3.6, errs


# ------------------------------------------------------------ tests/test_plex_exodus.py

@pytest.mark.parametrize("simplex,dim", [(True, 2), (False, 2), (True, 3), (False, 3)])
def test_exodus_roundtrip_and_cross_read(tmp_path, simplex, dim):
    """Each package reads back its own file and the other's."""
    faces = (3, 3) if dim == 2 else (2, 2, 2)
    p = DMPlex.createBoxMesh(faces, simplex=simplex)
    r = RPlex.createBoxMesh(faces, simplex=simplex)
    pp, rp = str(tmp_path / "port.exo"), str(tmp_path / "ref.exo")
    p.viewExodus(pp)
    r.viewExodus(rp)
    for reader, path in ((DMPlex, pp), (DMPlex, rp), (RPlex, pp), (RPlex, rp)):
        q = reader.createFromExodus(path)
        assert q.dim == p.dim and q.ncells == p.ncells and q.nvertices == p.nvertices
        assert np.allclose(q.coords, p.coords) and np.array_equal(q.cells, p.cells)


def test_exodus_node_sets_and_solve_after_load(tmp_path):
    """A loaded Exodus mesh (with two node sets, written here through
    scipy's netCDF writer) gives the reference's labels and solves as the
    reference's."""
    from scipy.io import netcdf_file
    init()
    p = DMPlex.createBoxMesh((4, 4))
    path = str(tmp_path / "m.exo")
    p.viewExodus(path)
    with netcdf_file(path, "a") as f:
        f.createDimension("num_node_sets", 2)
        f.createDimension("num_nod_ns1", 3)
        f.createDimension("num_nod_ns2", 2)
        v = f.createVariable("node_ns1", "i", ("num_nod_ns1",))
        v[:] = np.array([1, 2, 3], dtype=np.int32)
        v = f.createVariable("node_ns2", "i", ("num_nod_ns2",))
        v[:] = np.array([5, 6], dtype=np.int32)
        v = f.createVariable("ns_prop1", "i", ("num_node_sets",))
        v[:] = np.array([10, 20], dtype=np.int32)
    q, qr = DMPlex.createFromExodus(path), RPlex.createFromExodus(path)
    lbl, lr = q.labels["Vertex Sets"], qr.labels["Vertex Sets"]
    for val in (10, 20):
        assert np.array_equal(lbl.getStratumIS(val), lr.getStratumIS(val))
    assert list(lbl.getStratumIS(10)) == [0, 1, 2]
    (A, b), (Ar, br) = q.assemblePoissonP1(f=1.0), qr.assemblePoissonP1(f=1.0)
    u = _same_solve(_solve(pt, A, b, "cg", "jacobi", 1e-10),
                    _solve(pj, Ar, br, "cg", "jacobi", 1e-10), q.nvertices)
    assert np.abs(u).max() > 1e-4


def test_dmplex_exports():
    """DMPlex and Section where the reference exports them
    (petsc_tpu/__init__.py:78-80, petsc_tpu/dm/__init__.py)."""
    import petsc_tpu_torch.dm as tdm
    assert pt.DMPlex is DMPlex and pj.DMPlex is RPlex
    assert tdm.DMPlex is DMPlex and tdm.Section is Section
