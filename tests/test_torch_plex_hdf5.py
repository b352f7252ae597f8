"""petsc_tpu_torch's DMPlex HDF5 I/O (plex_io.py) against petsc_tpu, on the
CPU, after tests/test_plex_hdf5.py: the meshes, labels and section vectors
each package writes load in the other, in both directions, with equal
topology, coordinates, labels and values; the reference's XDMF-only layout
loads; a field written for another mesh is refused.

Tolerances: everything equal (the files carry the same bits)."""

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)


def _same(a, b):
    assert a.dim == b.dim and np.array_equal(np.asarray(a.cells), np.asarray(b.cells))
    assert np.array_equal(np.asarray(a.coords), np.asarray(b.coords))
    la, lb = getattr(a, "labels", None) or {}, getattr(b, "labels", None) or {}
    assert sorted(la) == sorted(lb) and all(np.array_equal(la[k], lb[k]) for k in la)


@pytest.mark.parametrize("faces,simplex", [((4, 3), True), ((2, 2, 2), True), ((3, 2), False)])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_meshes_cross_load(tmp_path, faces, simplex, writer):
    pt_jax.init(args=[])
    ptt.init(args=[], device="cpu")
    W, L = (DMPlex, RPlex) if writer == "port" else (RPlex, DMPlex)
    p = W.createBoxMesh(faces, simplex=simplex)
    p.labels = {"physical_7": np.array([0, 2, 5], dtype=np.int64), "walls": np.array([1, 3])}
    f = str(tmp_path / "mesh.h5")
    p.viewHDF5(f, name="box")
    for Loader in (L, W):
        q = Loader.createFromHDF5(f, name="box")
        _same(q, p)
        assert q.ncells == p.ncells and q.getLabel("physical_7") is not None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_section_vectors_cross_load_and_mismatch(tmp_path, writer):
    pt_jax.init(args=[])
    ptt.init(args=[], device="cpu")
    W, L = (DMPlex, RPlex) if writer == "port" else (RPlex, DMPlex)
    p = W.createBoxMesh((4, 4), simplex=True)
    f = str(tmp_path / "m.h5")
    p.viewHDF5(f)
    u = np.linspace(0, 1, p.nvertices)
    p.vecViewHDF5(f, "u", u if writer == "reference" else torch.as_tensor(u))
    p.vecViewHDF5(f, "v", (ptt if writer == "port" else pt_jax).Vec.from_array(2 * u))
    q = L.createFromHDF5(f)
    assert np.array_equal(q.vecLoadHDF5(f, "u"), u) and np.array_equal(q.vecLoadHDF5(f, "v"), 2 * u)
    for P, err in ((DMPlex, ptt.Error), (RPlex, pt_jax.Error)):
        with pytest.raises(err):
            P.createBoxMesh((2, 2), simplex=True).vecLoadHDF5(f, "u")


def test_xdmf_only_layout_loads(tmp_path):
    """A file carrying only the XDMF datasets (/viz/topology/cells and
    /geometry/vertices, plexhdf5xdmf.c) loads as the reference loads it."""
    ptt.init(args=[], device="cpu")
    p = DMPlex.createBoxMesh((3, 3), simplex=True)
    f = str(tmp_path / "xdmf.h5")
    with h5py.File(f, "w") as h:
        d = h.create_dataset("viz/topology/cells", data=np.asarray(p.cells, dtype=np.int64))
        d.attrs["cell_dim"] = np.int64(2)
        h.create_dataset("geometry/vertices", data=np.asarray(p.coords))
    q, r = DMPlex.createFromHDF5(f), RPlex.createFromHDF5(f)
    _same(q, r)
    assert q.ncells == p.ncells


def test_a_solve_on_a_loaded_mesh(tmp_path):
    """write -> load -> P1 Poisson -> CG, in both packages: equal
    iterations and solution (1e-10)."""
    out = []
    for pkg, P in ((pt_jax, RPlex), (ptt, DMPlex)):
        if pkg is ptt:
            ptt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10"],
                     device="cpu")
        else:
            pt_jax.init(args=["-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol", "1e-10"])
        f = str(tmp_path / f"s{len(out)}.h5")
        P.createBoxMesh((6, 6), simplex=True).viewHDF5(f)
        q = P.createFromHDF5(f)
        A, b = q.assemblePoissonP1(f=1.0)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        x = A.createVecRight()
        ksp.solve(b, x)
        out.append((ksp.getIterationNumber(), np.asarray(x.getArray())))
    assert out[0][0] == out[1][0]
    assert np.max(np.abs(out[0][1] - out[1][1])) <= 1e-10 * np.max(np.abs(out[0][1]))
