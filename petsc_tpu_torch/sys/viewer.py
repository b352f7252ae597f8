"""PetscViewer: ascii and PETSc-binary serialization.

Counterpart of ``petsc_tpu/sys/viewer.py``; the files are the reference's
byte for byte (values downloaded from the device once). Behavioral
reference: src/sys/classes/viewer (PetscViewer class) and the
binary readers/writers MatView_SeqAIJ_Binary (src/mat/impls/aij/seq/
aij.c:664), MatLoad_SeqAIJ (:4965), VecView/VecLoad (src/vec/vec/interface/
vector.c:856,1222). The PETSc binary format is big-endian:

  Vec: int32 VEC_FILE_CLASSID(1211214), int32 n, float64 vals[n]
  Mat: int32 MAT_FILE_CLASSID(1211216), int32 M, int32 N, int32 nnz,
       int32 rownz[M], int32 colidx[nnz], float64 vals[nnz]
  IS:  int32 IS_FILE_CLASSID(1211218), int32 n, int32 idx[n]

Reading/writing this format gives bit-exact interop with reference-produced
matrices (SuiteSparse conversions, checkpoints). npz checkpointing of
arbitrary object dicts is the fast path.
"""

from __future__ import annotations

import numpy as np

MAT_FILE_CLASSID = 1211216
VEC_FILE_CLASSID = 1211214
IS_FILE_CLASSID = 1211218

_I = ">i4"
_R = ">f8"


# ---------------------------------------------------------------------
# binary write
# ---------------------------------------------------------------------

def _vec_to_file(f, arr):
    arr = np.asarray(arr, dtype=np.float64)
    np.array([VEC_FILE_CLASSID, len(arr)], dtype=_I).tofile(f)
    arr.astype(_R).tofile(f)


def vec_save(path_or_file, vec, append=False):
    """VecView binary (vector.c:856)."""
    from ..vec.vec import Vec
    arr = vec.getArray() if isinstance(vec, Vec) else vec
    if hasattr(arr, "detach"):                     # a tensor, on any device
        arr = arr.detach().cpu().numpy()
    if hasattr(path_or_file, "write"):
        _vec_to_file(path_or_file, np.asarray(arr))
    else:
        with open(path_or_file, "ab" if append else "wb") as f:
            _vec_to_file(f, np.asarray(arr))


def _mat_to_file(f, indptr, indices, vals, shape):
    M, N = shape
    nnz = len(indices)
    np.array([MAT_FILE_CLASSID, M, N, nnz], dtype=_I).tofile(f)
    np.diff(indptr).astype(_I).tofile(f)
    np.asarray(indices).astype(_I).tofile(f)
    np.asarray(vals).astype(_R).tofile(f)


def mat_save(path_or_file, mat, append=False):
    """MatView binary (aij.c:664 format)."""
    indptr, indices, vals = mat.getValuesCSR()
    shape = mat.getSize()
    if hasattr(path_or_file, "write"):
        _mat_to_file(path_or_file, indptr, indices, vals, shape)
    else:
        with open(path_or_file, "ab" if append else "wb") as f:
            _mat_to_file(f, indptr, indices, vals, shape)


def is_save(path, iset, append=False):
    idx = np.asarray(iset, dtype=np.int64)
    with open(path, "ab" if append else "wb") as f:
        np.array([IS_FILE_CLASSID, len(idx)], dtype=_I).tofile(f)
        idx.astype(_I).tofile(f)


# ---------------------------------------------------------------------
# binary read
# ---------------------------------------------------------------------

def _read_header(f, n):
    h = np.fromfile(f, dtype=_I, count=n)
    if len(h) < n:
        raise EOFError("truncated PETSc binary file")
    return h


def load(path_or_file, comm=None):
    """Load the next object from a PETSc binary file; returns Vec, MatAIJ,
    or IS (by classid dispatch — VecLoad/MatLoad model)."""
    close = False
    if hasattr(path_or_file, "read"):
        f = path_or_file
    else:
        f = open(path_or_file, "rb")
        close = True
    try:
        # PetscInt-width autodetect: a reference build with 64-bit
        # indices (--with-64-bit-indices) writes the WHOLE integer
        # stream — classid included — as big-endian int64, so the first
        # 4 bytes of the file read 0 under an int32 view (classids are
        # ~1.2e6 << 2^32). Peek and pick the integer dtype per object.
        head = f.read(4)
        if len(head) < 4:
            raise EOFError("truncated PETSc binary file")
        ii = _I
        if int(np.frombuffer(head, dtype=">i4")[0]) == 0:
            ii = ">i8"
            head += f.read(4)
        cid = int(np.frombuffer(head, dtype=ii)[0])

        def rd_int(n):
            h = np.fromfile(f, dtype=ii, count=n)
            if len(h) < n:
                raise EOFError("truncated PETSc binary file")
            return h

        if cid == VEC_FILE_CLASSID:
            n = int(rd_int(1)[0])
            vals = np.fromfile(f, dtype=_R, count=n).astype(np.float64)
            from ..vec.vec import Vec
            return Vec.from_array(vals, comm=comm)
        if cid == MAT_FILE_CLASSID:
            M, N, nnz = (int(v) for v in rd_int(3))
            rownz = rd_int(M).astype(np.int64)
            indices = rd_int(nnz).astype(np.int64)
            vals = np.fromfile(f, dtype=_R, count=nnz).astype(np.float64)
            indptr = np.concatenate([[0], np.cumsum(rownz)])
            from ..mat.aij import MatAIJ
            A = MatAIJ(comm)
            A.setSizes((M, N))
            A.setValuesCSR(indptr, indices, vals)
            return A.assemble()
        if cid == IS_FILE_CLASSID:
            n = int(rd_int(1)[0])
            idx = rd_int(n).astype(np.int64)
            from ..parallel.index import IS
            return IS(idx, comm)
        raise ValueError(f"unknown PETSc binary classid {cid}")
    finally:
        if close:
            f.close()


def load_all(path, comm=None):
    """Load every object in the file in order (PETSc files may concatenate
    multiple objects, e.g. a Mat followed by RHS Vecs)."""
    out = []
    with open(path, "rb") as f:
        while True:
            try:
                out.append(load(f, comm))
            except EOFError:
                break
    return out


# ---------------------------------------------------------------------
# npz checkpoint
# ---------------------------------------------------------------------

def checkpoint_save(path, **objs):
    """Save named Vecs/Mats/arrays into one npz (orbax-style object
    checkpoint; keeps {layout, i, j, a} per SURVEY §5)."""
    from ..mat.mat import Mat
    from ..vec.vec import Vec
    data = {}
    for name, o in objs.items():
        if isinstance(o, Vec):
            data[f"vec::{name}"] = np.asarray(o.getArray())
        elif isinstance(o, Mat):
            i, j, a = o.getValuesCSR()
            m, n = o.getSize()
            data[f"mat_i::{name}"] = i
            data[f"mat_j::{name}"] = j
            data[f"mat_a::{name}"] = a
            data[f"mat_shape::{name}"] = np.array([m, n])
        else:
            data[f"arr::{name}"] = np.asarray(o)
    np.savez_compressed(path, **data)


def checkpoint_load(path, comm=None):
    from ..mat.aij import MatAIJ
    from ..vec.vec import Vec
    z = np.load(path)
    out = {}
    mats = {}
    for k in z.files:
        kind, name = k.split("::", 1)
        if kind == "vec":
            out[name] = Vec.from_array(z[k], comm=comm)
        elif kind == "arr":
            out[name] = z[k]
        else:
            mats.setdefault(name, {})[kind] = z[k]
    for name, d in mats.items():
        A = MatAIJ(comm)
        A.setSizes(tuple(int(v) for v in d["mat_shape"]))
        A.setValuesCSR(d["mat_i"], d["mat_j"], d["mat_a"])
        out[name] = A.assemble()
    return out
