"""VTK / VTU solution output (ParaView interop).

Counterpart of ``petsc_tpu/sys/vtk.py``; the files are the reference's
byte for byte (data downloaded from the device once). Behavioral
reference: src/sys/classes/viewer/impls/vtk (PETSCVIEWERVTK)
and src/dm/impls/plex/plexvtu.c (DMPlexVTKWriteAll_VTU) — the standard
visualization path `-ksp_view_solution vtk:sol.vtu`. Two writers:

  write_vtu(dm, path, point_data=..., cell_data=...)  — XML
      UnstructuredGrid (.vtu, appended raw binary like plexvtu.c) for
      DMPlex, or ImageData (.vti) for DMDA/structured grids;
  write_vtk(dm, path, ...)                             — legacy ASCII
      .vtk (UNSTRUCTURED_GRID / STRUCTURED_POINTS).

Cell types map to VTK ids the way plexvtu.c's DMPlexVTKGetCellType does:
tri 5, quad 9, tet 10, hex 12.
"""

from __future__ import annotations

import base64
import struct

import numpy as np

_VTK_CELL = {(2, 3): 5, (2, 4): 9, (3, 4): 10, (3, 8): 12}


def _as_np(v, n=None):
    a = getattr(v, "getArray", lambda: v)()
    if hasattr(a, "detach"):                       # a tensor, on any device
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    if n is not None:
        a = a[:n] if a.ndim == 1 else a[:n, :]
    return np.asarray(a, dtype=np.float64)


def _plex_arrays(dm):
    cells = np.asarray(dm.cells, dtype=np.int64)
    coords = np.asarray(dm.coords, dtype=np.float64)
    if coords.shape[1] < 3:
        coords = np.pad(coords, ((0, 0), (0, 3 - coords.shape[1])))
    ctype = _VTK_CELL.get((dm.dim, cells.shape[1]))
    if ctype is None:
        raise ValueError(f"VTK: unsupported cell (dim={dm.dim}, "
                         f"nv={cells.shape[1]})")
    return cells, coords, ctype


def write_vtu(dm, path, point_data=None, cell_data=None):
    """XML .vtu (UnstructuredGrid) for a DMPlex, or .vti (ImageData) for
    a structured grid shape tuple / DMDA. Data arrays are float64 base64
    (inline binary — ParaView-readable without appended-offset
    bookkeeping)."""
    point_data = point_data or {}
    cell_data = cell_data or {}
    if hasattr(dm, "cells"):
        return _write_vtu_plex(dm, path, point_data, cell_data)
    return _write_vti_grid(dm, path, point_data)


def _b64(arr):
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _darray(name, arr, ncomp=1):
    typ = {np.dtype(np.float64): "Float64",
           np.dtype(np.int64): "Int64",
           np.dtype(np.uint8): "UInt8",
           np.dtype(np.int32): "Int32"}[np.dtype(arr.dtype)]
    return (f'<DataArray type="{typ}" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="binary">\n'
            f"{_b64(arr)}\n</DataArray>\n")


def _write_vtu_plex(dm, path, point_data, cell_data):
    cells, coords, ctype = _plex_arrays(dm)
    nc, nv = len(cells), len(coords)
    out = ['<?xml version="1.0"?>\n'
           '<VTKFile type="UnstructuredGrid" version="0.1" '
           'byte_order="LittleEndian">\n<UnstructuredGrid>\n'
           f'<Piece NumberOfPoints="{nv}" NumberOfCells="{nc}">\n']
    out.append("<Points>\n")
    out.append(_darray("Points", coords.reshape(-1), ncomp=3))
    out.append("</Points>\n<Cells>\n")
    out.append(_darray("connectivity", cells.reshape(-1)))
    out.append(_darray("offsets",
                       (np.arange(1, nc + 1) * cells.shape[1])
                       .astype(np.int64)))
    out.append(_darray("types", np.full(nc, ctype, dtype=np.uint8)))
    out.append("</Cells>\n")
    if point_data:
        out.append("<PointData>\n")
        for name, v in point_data.items():
            a = _as_np(v, nv)
            ncomp = 1 if a.ndim == 1 else a.shape[1]
            out.append(_darray(name, a.reshape(-1), ncomp=ncomp))
        out.append("</PointData>\n")
    if cell_data:
        out.append("<CellData>\n")
        for name, v in cell_data.items():
            a = _as_np(v, nc)
            ncomp = 1 if a.ndim == 1 else a.shape[1]
            out.append(_darray(name, a.reshape(-1), ncomp=ncomp))
        out.append("</CellData>\n")
    out.append("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
    with open(path, "w") as f:
        f.write("".join(out))
    return path


def _grid_shape(dm):
    if isinstance(dm, tuple):
        return tuple(int(s) for s in dm)
    sizes = getattr(dm, "sizes", None)
    if sizes is not None:
        return tuple(int(s) for s in sizes[::-1])   # (nz, ny, nx)
    raise ValueError("VTK: need a DMPlex, DMDA, or grid-shape tuple")


def _write_vti_grid(dm, path, point_data):
    shape = _grid_shape(dm)                         # (…, ny, nx)
    while len(shape) < 3:
        shape = (1,) + shape
    nz, ny, nx = shape
    ext = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    out = ['<?xml version="1.0"?>\n'
           '<VTKFile type="ImageData" version="0.1" '
           'byte_order="LittleEndian">\n'
           f'<ImageData WholeExtent="{ext}" Origin="0 0 0" '
           'Spacing="1 1 1">\n'
           f'<Piece Extent="{ext}">\n<PointData>\n']
    npts = nx * ny * nz
    for name, v in (point_data or {}).items():
        a = _as_np(v, npts)
        ncomp = 1 if a.ndim == 1 else a.shape[1]
        out.append(_darray(name, a.reshape(-1), ncomp=ncomp))
    out.append("</PointData>\n</Piece>\n</ImageData>\n</VTKFile>\n")
    with open(path, "w") as f:
        f.write("".join(out))
    return path


def write_vtk(dm, path, point_data=None, cell_data=None):
    """Legacy ASCII .vtk writer (UNSTRUCTURED_GRID for plex,
    STRUCTURED_POINTS for grids)."""
    point_data = point_data or {}
    cell_data = cell_data or {}
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\npetsc_tpu\nASCII\n")   # the reference's title line
        if hasattr(dm, "cells"):
            cells, coords, ctype = _plex_arrays(dm)
            nc, nv = len(cells), len(coords)
            f.write("DATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {nv} double\n")
            np.savetxt(f, coords, fmt="%.16g")
            f.write(f"CELLS {nc} {nc * (cells.shape[1] + 1)}\n")
            np.savetxt(f, np.column_stack(
                [np.full(nc, cells.shape[1]), cells]), fmt="%d")
            f.write(f"CELL_TYPES {nc}\n")
            np.savetxt(f, np.full(nc, ctype), fmt="%d")
            npts = nv
        else:
            shape = _grid_shape(dm)
            while len(shape) < 3:
                shape = (1,) + shape
            nz, ny, nx = shape
            f.write("DATASET STRUCTURED_POINTS\n")
            f.write(f"DIMENSIONS {nx} {ny} {nz}\n")
            f.write("ORIGIN 0 0 0\nSPACING 1 1 1\n")
            npts = nx * ny * nz
        wrote_pd = False
        for name, v in point_data.items():
            a = _as_np(v, npts)
            if not wrote_pd:
                f.write(f"POINT_DATA {npts}\n")
                wrote_pd = True
            if a.ndim == 1:
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, a, fmt="%.16g")
            else:
                f.write(f"VECTORS {name} double\n")
                a3 = np.pad(a, ((0, 0), (0, 3 - a.shape[1])))
                np.savetxt(f, a3, fmt="%.16g")
        for name, v in cell_data.items():
            a = _as_np(v)
            f.write(f"CELL_DATA {len(a)}\n")
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            np.savetxt(f, a, fmt="%.16g")
    return path
