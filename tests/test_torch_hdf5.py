"""petsc_tpu_torch's ViewerHDF5 against petsc_tpu, on the CPU, after
tests/test_hdf5_log.py: Vecs (also timestepped) and Mats written by either
package load in the other, in both directions; h5py's absence raises an
Error naming it.

Tolerances: everything equal (the files carry the same bits)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.sys.hdf5 import ViewerHDF5 as RViewer
from petsc_tpu_torch.sys.hdf5 import ViewerHDF5

pytest.importorskip("h5py")
torch.set_num_threads(1)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_vec_and_mat_cross_load(tmp_path, writer):
    pt_jax.init(args=[])
    ptt.init(args=[], device="cpu")
    A0 = sp.random(12, 9, density=0.4, random_state=0, format="csr")
    v0 = np.random.default_rng(1).random(7)
    (Wv, Wpkg), (Rv, Rpkg) = ((ViewerHDF5, ptt), (RViewer, pt_jax))[::1 if writer == "port" else -1]
    p = str(tmp_path / "o.h5")
    with Wv(p, "w") as w:
        w.pushGroup("/fields")
        w.writeVec("u", Wpkg.Vec.from_array(v0))
        w.writeMat("A", Wpkg.MatAIJ.from_scipy(A0))
        w.pushGroup("sub")
        assert w.getGroup() == "/fields/sub"
        w.writeVec("t", torch.as_tensor(v0) if Wpkg is ptt else v0)
        w.popGroup()
        w.writeAttr("/fields/u", "units", "V")
        w.popGroup()
    for V, pkg in ((Rv, Rpkg), (Wv, Wpkg)):
        with V(p, "r") as r:
            r.pushGroup("/fields")
            assert r.hasDataset("u") and not r.hasDataset("zzz")
            v1, A1 = r.loadVec("u"), r.loadMat("A")
            r.pushGroup("sub")
            t1 = r.loadVec("t")
        assert np.array_equal(np.asarray(v1.getArray())[:7], v0)
        assert np.array_equal(np.asarray(t1.getArray())[:7], v0)
        S = A1.to_scipy()
        assert S.shape == A0.shape and (S != A0).nnz == 0


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_timestepping_cross_loads(tmp_path, writer):
    ptt.init(args=[], device="cpu")
    pt_jax.init(args=[])
    W, R, Wpkg = (ViewerHDF5, RViewer, ptt) if writer == "port" else (RViewer, ViewerHDF5, pt_jax)
    p = str(tmp_path / "ts.h5")
    with W(p, "w") as w:
        w.pushTimestepping()
        for k in range(3):
            w.setTimestep(k)
            w.writeVec("u", Wpkg.Vec.from_array(np.full(4, float(k))))
        w.incrementTimestep()
        w.writeVec("u", Wpkg.Vec.from_array(np.full(4, 9.0)))
    with R(p, "r") as r:
        for k, val in enumerate((0.0, 1.0, 2.0, 9.0)):
            assert np.array_equal(np.asarray(r.loadVec("u", timestep=k).getArray())[:4],
                                  np.full(4, val))


def test_a_missing_h5py_raises_naming_it(monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py":
            raise ImportError("no h5py here")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ptt.Error, match="h5py"):
        ViewerHDF5(str(tmp_path / "x.h5"), "w")
