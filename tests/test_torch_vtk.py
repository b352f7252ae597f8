"""petsc_tpu_torch's VTK writers against petsc_tpu, on the CPU, after
tests/test_vtk.py: write_vtu (.vtu for a DMPlex, .vti for a DMDA or a
grid shape) and write_vtk (legacy ASCII) give the reference's bytes for
the same data, from Vecs, tensors and arrays; -ksp_view_solution vtk
writes the solution.

Tolerances: bytes equal."""

import base64
import re
import struct

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu.sys.vtk import write_vtk as rwrite_vtk, write_vtu as rwrite_vtu
from petsc_tpu_torch.dm.plex import DMPlex
from petsc_tpu_torch.sys.vtk import write_vtk, write_vtu

torch.set_num_threads(1)


def _init(args=()):
    pt_jax.init(args=list(args))
    ptt.init(args=list(args), device="cpu")


@pytest.mark.parametrize("faces,simplex", [((3, 3), True), ((2, 2), False), ((2, 2, 2), True),
                                           ((2, 2, 2), False)])
@pytest.mark.parametrize("suffix", ["vtu", "vtk"])
def test_plex_files_are_the_references_bytes(tmp_path, faces, simplex, suffix):
    _init()
    p, r = DMPlex.createBoxMesh(faces, simplex=simplex), RPlex.createBoxMesh(faces, simplex=simplex)
    u = np.sin(r.coords[:, 0]) + r.coords[:, 1]
    g = np.stack([u, 2 * u], axis=1)
    c = np.arange(float(r.ncells))
    W, RW = (write_vtu, rwrite_vtu) if suffix == "vtu" else (write_vtk, rwrite_vtk)
    W(p, str(tmp_path / f"p.{suffix}"), point_data={"u": ptt.Vec.from_array(u),
                                                   "g": torch.as_tensor(g)},
      cell_data={"c": torch.as_tensor(c)})
    RW(r, str(tmp_path / f"r.{suffix}"), point_data={"u": u, "g": g}, cell_data={"c": c})
    assert (tmp_path / f"p.{suffix}").read_bytes() == (tmp_path / f"r.{suffix}").read_bytes()
    if suffix == "vtu":
        txt = (tmp_path / "p.vtu").read_text()
        m = re.search(r'Name="u"[^>]*>\s*([A-Za-z0-9+/=]+)\s*</DataArray>', txt)
        raw = base64.b64decode(m.group(1))
        nb = struct.unpack("<I", raw[:4])[0]
        assert np.array_equal(np.frombuffer(raw[4:4 + nb], dtype=np.float64), u)


@pytest.mark.parametrize("shape", [(4, 5, 6), (7, 3), (9,)])
def test_grid_files_are_the_references_bytes(tmp_path, shape):
    """A DMDA (sizes x first) and a grid-shape tuple (slowest first)."""
    _init()
    n = int(np.prod(shape))
    u = np.cos(np.arange(n) * 0.3)
    for W, RW, suf in ((write_vtu, rwrite_vtu, "vti"), (write_vtk, rwrite_vtk, "vtk")):
        W(shape, str(tmp_path / f"p.{suf}"), point_data={"u": torch.as_tensor(u)})
        RW(shape, str(tmp_path / f"r.{suf}"), point_data={"u": u})
        assert (tmp_path / f"p.{suf}").read_bytes() == (tmp_path / f"r.{suf}").read_bytes()
        da, rda = ptt.DMDA.create(len(shape), shape[::-1]), pt_jax.DMDA.create(len(shape),
                                                                              shape[::-1])
        v = da.createGlobalVector()
        v.setArray(u)
        W(da, str(tmp_path / f"pd.{suf}"), point_data={"u": v})
        RW(rda, str(tmp_path / f"rd.{suf}"), point_data={"u": u})
        assert (tmp_path / f"pd.{suf}").read_bytes() == (tmp_path / f"rd.{suf}").read_bytes()
    with pytest.raises(ValueError):
        write_vtu(object(), str(tmp_path / "bad.vti"))


def test_ksp_view_solution_vtk(tmp_path):
    """-ksp_view_solution vtk:sol.vtu on a plex's P1 Poisson: the
    solution's array, and the reference's file where the solutions agree
    in bits (a 2 x 2 mesh with one interior vertex)."""
    out = {}
    for pkg, P, tag in ((pt_jax, RPlex, "r"), (ptt, DMPlex, "p")):
        path = str(tmp_path / f"{tag}.vtu")
        args = ["-ksp_view_solution", f"vtk:{path}"]
        if pkg is ptt:
            ptt.init(args=args, device="cpu")
        else:
            pt_jax.init(args=args)
        mesh = P.createBoxMesh((4, 4), simplex=True)
        A, b = mesh.assemblePoissonP1(f=1.0)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setType("cg")
        ksp.getPC().setType("jacobi")
        ksp.setTolerances(rtol=1e-8, max_it=200)
        x = A.createVecRight()
        ksp.solve(b, x)
        out[tag] = (open(path).read(), np.asarray(x.getArray()))
    assert 'Name="solution"' in out["p"][0]
    m = re.search(r'Name="solution"[^>]*>\s*([A-Za-z0-9+/=]+)\s*</DataArray>', out["p"][0])
    raw = base64.b64decode(m.group(1))
    assert np.array_equal(np.frombuffer(raw[4:], dtype=np.float64), out["p"][1])
    assert np.max(np.abs(out["p"][1] - out["r"][1])) <= 1e-12
    head = out["p"][0].split('Name="solution"')[0]
    assert head == out["r"][0].split('Name="solution"')[0]
