"""ExodusII mesh IO for DMPlex (plexexodusii.c role; counterpart of
``petsc_tpu/dm/plex_exodus.py``) — WITHOUT the
netCDF-C library: ExodusII files are netCDF-3 classic containers, which
scipy.io.netcdf_file reads and writes natively. Covers the mesh
interchange subset the reference's DMPlexCreateExodus / DMView(exodus)
use: coordinates, element blocks (TRI3/QUAD4/TETRA4/HEX8), node sets
(vertex labels), side sets skipped (reference marks them optional for
topology-only interchange).
"""

from __future__ import annotations

import numpy as np

from ..sys.error import Error

_BLOCK_TYPES = {
    ("TRI", 3): (2, 3), ("TRI3", 3): (2, 3),
    ("TRIANGLE", 3): (2, 3),
    ("QUAD", 4): (2, 4), ("QUAD4", 4): (2, 4),
    ("TETRA", 4): (3, 4), ("TETRA4", 4): (3, 4), ("TET4", 4): (3, 4),
    ("HEX", 8): (3, 8), ("HEX8", 8): (3, 8),
}


def plex_load_exodus(path, comm=None):
    """DMPlexCreateExodusFromFile: read an ExodusII (.exo/.e) mesh. All
    element blocks must share one cell shape (the lite plex's single
    cell array); node sets become DMLabels named by their ids."""
    from scipy.io import netcdf_file
    from .plex import DMPlex
    f = netcdf_file(path, "r", mmap=False)
    try:
        dim = int(f.dimensions["num_dim"])
        nn = int(f.dimensions["num_nodes"])
        # coordinates: either one (dim, nn) 'coord' or coordx/y/z
        if "coord" in f.variables:
            coords = np.array(f.variables["coord"][:dim, :nn],
                              dtype=np.float64).T
        else:
            axes = ["coordx", "coordy", "coordz"][:dim]
            coords = np.stack(
                [np.array(f.variables[a][:nn], dtype=np.float64)
                 for a in axes], axis=1)
        nblk = int(f.dimensions.get("num_el_blk", 1))
        cells = []
        shape = None
        for b in range(1, nblk + 1):
            var = f.variables[f"connect{b}"]
            etype = getattr(var, "elem_type", b"").decode() \
                if isinstance(getattr(var, "elem_type", ""), bytes) \
                else str(getattr(var, "elem_type", ""))
            conn = np.array(var[:], dtype=np.int64) - 1   # 1-based
            key = (etype.upper().strip(), conn.shape[1])
            if key not in _BLOCK_TYPES:
                raise Error(f"exodus: unsupported element type "
                            f"{etype}/{conn.shape[1]} nodes")
            d, nv = _BLOCK_TYPES[key]
            if shape is None:
                shape = (d, nv)
            elif shape != (d, nv):
                raise Error("exodus: mixed element shapes unsupported "
                            "(lite plex carries one cell array)")
            cells.append(conn)
        if shape is None or shape[0] != dim:
            raise Error("exodus: no readable element blocks")
        p = DMPlex.createFromCellList(dim, np.concatenate(cells), coords,
                                      comm=comm)
        # node sets -> vertex DMLabels (ns_prop1 ids when present)
        nns = int(f.dimensions.get("num_node_sets", 0) or 0)
        if nns:
            from .label import DMLabel
            ids = np.array(f.variables["ns_prop1"][:nns],
                           dtype=np.int64) if "ns_prop1" in f.variables \
                else np.arange(1, nns + 1)
            lbl = DMLabel("Vertex Sets")
            for s in range(1, nns + 1):
                nodes = np.array(f.variables[f"node_ns{s}"][:],
                                 dtype=np.int64) - 1
                lbl.insertIS(nodes, int(ids[s - 1]))
            p.labels = getattr(p, "labels", {})
            p.labels["Vertex Sets"] = lbl
        return p
    finally:
        f.close()


_ELEM_NAMES = {(2, 3): "TRI3", (2, 4): "QUAD4",
               (3, 4): "TETRA4", (3, 8): "HEX8"}


def plex_view_exodus(plex, path, title="petsc_tpu_torch plex"):
    """DMView to ExodusII (one element block; the interchange layout
    DMPlexCreateExodusFromFile and paraview read)."""
    from scipy.io import netcdf_file
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    dim = plex.dim
    key = (dim, cells.shape[1])
    if key not in _ELEM_NAMES:
        raise Error(f"exodus write: unsupported cell shape {key}")
    f = netcdf_file(path, "w")
    try:
        f.title = title.encode()
        f.createDimension("num_dim", dim)
        f.createDimension("num_nodes", len(coords))
        f.createDimension("num_elem", len(cells))
        f.createDimension("num_el_blk", 1)
        f.createDimension("num_el_in_blk1", len(cells))
        f.createDimension("num_nod_per_el1", cells.shape[1])
        f.createDimension("len_string", 33)
        v = f.createVariable("coord", "d", ("num_dim", "num_nodes"))
        v[:] = coords.T
        c = f.createVariable("connect1", "i",
                             ("num_el_in_blk1", "num_nod_per_el1"))
        c[:] = (cells + 1).astype(np.int32)
        c.elem_type = _ELEM_NAMES[key].encode()
        eb = f.createVariable("eb_prop1", "i", ("num_el_blk",))
        eb[:] = np.array([1], dtype=np.int32)
    finally:
        f.close()
    return path
