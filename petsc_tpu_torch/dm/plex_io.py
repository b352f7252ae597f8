"""DMPlex HDF5 mesh I/O.

Counterpart of ``petsc_tpu/dm/plex_io.py``, with its file layout, so a
mesh or a field written by either package loads in the other. Behavioral
reference: src/dm/impls/plex/hdf5/plexhdf5.c
(DMPlexTopologyView_HDF5 / DMPlexTopologyLoad_HDF5, the legacy
"order/cones/cells/orientation" layout and the `cell_dim` attribute) and
src/dm/impls/plex/hdf5/plexhdf5xdmf.c (DMPlexCreateFromFile's XDMF-ish
reader: datasets `/viz/topology/cells` (ncells, ncorners) with attribute
`cell_dim`, and `/geometry/vertices` (nv, dim)).

Two layouts are written into one file:

* the XDMF/viz layout — `/viz/topology/cells` + `/geometry/vertices` —
  the interchange format the reference itself loads via
  `DMPlexCreateFromFile("*.h5")`, so meshes written here are readable by
  reference tooling and vice versa;
* a `topologies/<name>/` group carrying the round-trip extras:
  cone sizes, labels (one index-set dataset per (label, value) stratum)
  and named section vectors (`fields/<field>`), mirroring the reference's
  DMPlexTopologyView group structure for its new-style format.

The loader prefers `topologies/<name>` (full round-trip incl. labels)
and falls back to the viz/XDMF datasets, which is enough to ingest a
reference-written file.

I/O is host-side (never a device concern); everything crosses
host<->device only when the mesh is subsequently used.
"""

from __future__ import annotations

import numpy as np

from ..sys.error import Error
from ..sys.hdf5 import h5py_module as _h5


def plex_view_hdf5(plex, path, name="plex", mode="w"):
    """Write mesh topology+coordinates+labels (DMView_Plex HDF5 role)."""
    h5py = _h5()
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    with h5py.File(path, mode) as f:
        # XDMF / DMPlexCreateFromFile-compatible datasets
        viz = f.require_group("viz").require_group("topology")
        if "cells" in viz:
            del viz["cells"]
        dset = viz.create_dataset("cells", data=cells)
        dset.attrs["cell_dim"] = np.int64(plex.dim)
        geo = f.require_group("geometry")
        if "vertices" in geo:
            del geo["vertices"]
        geo.create_dataset("vertices", data=coords)
        # round-trip group (new-style DMPlexTopologyView shape)
        if f"topologies/{name}" in f:
            del f[f"topologies/{name}"]
        g = f.require_group(f"topologies/{name}")
        g.attrs["cell_dim"] = np.int64(plex.dim)
        g.attrs["depth"] = np.int64(1)
        topo = g.create_group("topology")
        topo.create_dataset("cells", data=cells)
        topo.create_dataset("cone_sizes",
                            data=np.full(len(cells), cells.shape[1],
                                         dtype=np.int64))
        topo.create_dataset("order",
                            data=np.arange(len(cells) + len(coords),
                                           dtype=np.int64))
        g.create_group("geometry").create_dataset("vertices", data=coords)
        labels = g.create_group("labels")
        for lname, pts in (getattr(plex, "labels", None) or {}).items():
            lg = labels.create_group(lname)
            val = (int(lname.split("_", 1)[1])
                   if lname.startswith("physical_")
                   and lname.split("_", 1)[1].isdigit() else 1)
            vg = lg.create_group(str(val))
            vg.create_dataset("indices",
                              data=np.asarray(pts, dtype=np.int64))
    return path


def plex_load_hdf5(path, name=None, comm=None):
    """Load a DMPlex from HDF5 (DMPlexCreateFromFile .h5 role): prefers
    the round-trip `topologies/<name>` group, falls back to the
    XDMF-style `/viz/topology/cells` (+ `/topology/cells`) and
    `/geometry/vertices` datasets a reference-written file carries."""
    from .plex import DMPlex
    h5py = _h5()
    with h5py.File(path, "r") as f:
        grp = None
        if "topologies" in f:
            names = list(f["topologies"].keys())
            pick = name if name is not None else \
                (names[0] if names else None)
            if pick is not None and pick in f["topologies"]:
                grp = f[f"topologies/{pick}"]
        if grp is not None:
            cells = np.asarray(grp["topology/cells"], dtype=np.int64)
            coords = np.asarray(grp["geometry/vertices"], dtype=np.float64)
            dim = int(grp.attrs.get("cell_dim", coords.shape[1]))
            p = DMPlex.createFromCellList(dim, cells, coords, comm=comm)
            labels = {}
            for lname, lg in grp.get("labels", {}).items():
                for _val, vg in lg.items():
                    labels[lname] = np.asarray(vg["indices"],
                                               dtype=np.int64)
            if labels:
                p.labels = labels
            return p
        # XDMF fallback (plexhdf5xdmf.c reader's dataset paths)
        topo = None
        for cand in ("viz/topology/cells", "topology/cells"):
            if cand in f:
                topo = f[cand]
                break
        if topo is None or "geometry/vertices" not in f:
            raise Error(f"plex_load_hdf5: no topology found in {path}")
        cells = np.asarray(topo, dtype=np.int64)
        coords = np.asarray(f["geometry/vertices"], dtype=np.float64)
        dim = int(topo.attrs.get("cell_dim", coords.shape[1]))
        if cells.ndim == 1:  # flat cell list with uniform corner count
            nc = len(cells) // max(len(coords), 1)
            cells = cells.reshape(-1, nc)
        return DMPlex.createFromCellList(dim, cells, coords, comm=comm)


def plex_vec_view_hdf5(plex, path, vname, vec, name="plex"):
    """VecView on a plex section vector: stored under the mesh's
    round-trip group (fields/<vname>) with the vertex count recorded so
    loads can sanity-check against the mesh (VecView_Plex_HDF5 role)."""
    h5py = _h5()
    arr = vec.getArray() if hasattr(vec, "getArray") else vec
    if hasattr(arr, "detach"):                     # a tensor, on any device
        arr = arr.detach().cpu().numpy()
    with h5py.File(path, "a") as f:
        g = f.require_group(f"topologies/{name}").require_group("fields")
        if vname in g:
            del g[vname]
        d = g.create_dataset(vname, data=np.asarray(arr, dtype=np.float64))
        d.attrs["nvertices"] = np.int64(plex.nvertices)


def plex_vec_load_hdf5(plex, path, vname, name="plex"):
    h5py = _h5()
    with h5py.File(path, "r") as f:
        d = f[f"topologies/{name}/fields/{vname}"]
        nv = int(d.attrs.get("nvertices", -1))
        if nv >= 0 and nv != plex.nvertices:
            raise Error(f"plex_vec_load_hdf5: field {vname} written for "
                        f"{nv} vertices, mesh has {plex.nvertices}")
        return np.asarray(d, dtype=np.float64)
