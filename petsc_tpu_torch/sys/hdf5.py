"""PetscViewerHDF5: HDF5 object I/O.

Counterpart of ``petsc_tpu/sys/hdf5.py`` (reference
src/sys/classes/viewer/impls/hdf5/hdf5v.c
(PetscViewerHDF5Open, PushGroup/PopGroup, timestepping), VecView_MPI_HDF5
(src/vec/impls/mpi/pdvec.c) and MatView_AIJ_HDF5. Layout matches the
reference's conventions so h5py/petsc4py users find what they expect:

  Vec  -> dataset <group>/<name>                 (shape (n,) float64)
  Mat  -> group   <group>/<name>/{jc,ir,data,MATLAB_sparse-ish attrs}
          plus a plain "csr" triple the TPU loader prefers
  timestepped vecs -> dataset with a leading timestep axis

The layout is the reference's, so a file written by either package loads
in the other. The viewer is host-side; arrays cross host<->device only at
save/load boundaries. h5py is imported when a viewer opens, and its absence
raises an Error that names it.
"""

from __future__ import annotations

import numpy as np

from .error import Error


def h5py_module():
    """h5py, or an Error naming it when it is not installed."""
    try:
        import h5py
    except ImportError as e:
        raise Error("HDF5 I/O needs the h5py package, which is not installed") from e
    return h5py


class ViewerHDF5:
    """PetscViewerHDF5 analog. Usage:

        v = ViewerHDF5("out.h5", mode="w")
        v.pushGroup("/fields"); v.writeVec("u", u); v.popGroup()
        v.destroy()
    """

    def __init__(self, path, mode="r"):
        self._f = h5py_module().File(path, mode)
        self._groups = ["/"]
        self._timestep = -1   # -1: timestepping off (hdf5v.c semantics)

    # ---- group stack (PetscViewerHDF5PushGroup/PopGroup) ----

    def pushGroup(self, name):
        base = self._groups[-1]
        full = name if name.startswith("/") else base.rstrip("/") + "/" + name
        self._groups.append(full)
        self._f.require_group(full)
        return self

    def popGroup(self):
        if len(self._groups) > 1:
            self._groups.pop()
        return self

    def getGroup(self):
        return self._groups[-1]

    # ---- timestepping (PetscViewerHDF5PushTimestepping) ----

    def pushTimestepping(self):
        self._timestep = max(self._timestep, 0)
        return self

    def incrementTimestep(self):
        self._timestep += 1
        return self

    def setTimestep(self, t):
        self._timestep = int(t)
        return self

    # ---- write ----

    def _path(self, name):
        return self._groups[-1].rstrip("/") + "/" + name

    def writeVec(self, name, vec):
        arr = np.asarray(vec.getArray() if hasattr(vec, "getArray") else vec,
                         dtype=np.float64)
        p = self._path(name)
        if self._timestep >= 0:
            if p in self._f:
                ds = self._f[p]
                ds.resize(self._timestep + 1, axis=0)
            else:
                ds = self._f.create_dataset(
                    p, shape=(self._timestep + 1, len(arr)),
                    maxshape=(None, len(arr)), dtype="f8")
            ds[self._timestep] = arr
        else:
            if p in self._f:
                del self._f[p]
            self._f.create_dataset(p, data=arr)
        return self

    def writeMat(self, name, mat):
        i, j, a = mat.getValuesCSR()
        m, n = mat.getSize()
        p = self._path(name)
        if p in self._f:
            del self._f[p]
        g = self._f.create_group(p)
        g.create_dataset("jc", data=np.asarray(i, dtype=np.int64))
        g.create_dataset("ir", data=np.asarray(j, dtype=np.int64))
        g.create_dataset("data", data=np.asarray(a, dtype=np.float64))
        g.attrs["MATLAB_sparse"] = n      # hdf5v.c MATLAB-compat attr
        g.attrs["shape"] = (m, n)
        return self

    def writeAttr(self, obj_path, key, value):
        self._f[obj_path].attrs[key] = value
        return self

    # ---- read ----

    def loadVec(self, name, comm=None, timestep=None):
        from ..vec.vec import Vec
        ds = self._f[self._path(name)]
        arr = np.asarray(ds[timestep] if timestep is not None
                         else (ds[self._timestep] if self._timestep >= 0
                               and ds.ndim == 2 else ds))
        return Vec.from_array(arr, comm=comm)

    def loadMat(self, name, comm=None):
        import scipy.sparse as sp
        from ..mat.aij import MatAIJ
        g = self._f[self._path(name)]
        i = np.asarray(g["jc"])
        j = np.asarray(g["ir"])
        a = np.asarray(g["data"])
        m = len(i) - 1
        n = int(g.attrs.get("MATLAB_sparse", g.attrs.get("shape", (m, m))[1]))
        A = sp.csr_matrix((a, j, i), shape=(m, n))
        return MatAIJ.from_scipy(A, comm=comm)

    def hasDataset(self, name):
        return self._path(name) in self._f

    def flush(self):
        self._f.flush()
        return self

    def destroy(self):
        self._f.close()

    close = destroy

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()
