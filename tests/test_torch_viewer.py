"""petsc_tpu_torch's PETSc binary viewer and npz checkpoints against
petsc_tpu, on the CPU, after tests/test_viewer.py: the files each package
writes are byte for byte the other's (Vec, Mat, IS, concatenated
objects), each loads the other's (also a 64-bit-index file), and
-ksp_view_solution writes the reference's file.

Tolerances: bytes equal."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.sys import viewer as rviewer
from petsc_tpu_torch.ops.stencil_build import stencil7_coo
from petsc_tpu_torch.parallel.index import IS
from petsc_tpu_torch.sys import viewer
from tests.test_mg_gamg import poisson2d

torch.set_num_threads(1)


def _init(args=()):
    pt_jax.init(args=list(args))
    ptt.init(args=list(args), device="cpu")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_vec_mat_and_is_files_are_the_references_bytes(tmp_path):
    """Each object written alone and all concatenated; the port's Mat from
    COO on its device copy (the config-2 stencil at 4 x 9 x 9), a Vec from a
    tensor."""
    _init()
    i, j, v = stencil7_coo(4, 9, 9)
    n = 4 * 9 * 9
    A = ptt.MatAIJ()
    A.setSizes(n)
    A.setPreallocationCOO(i, j)
    A.setValuesCOO(v)
    R = pt_jax.MatAIJ.from_scipy(sp.csr_matrix((v, (i, j)), shape=(n, n)))
    x = np.cos(0.1 * np.arange(n))
    idx = np.array([5, 1, 7, 3])
    for what, port, ref in (
            ("vec", lambda p: viewer.vec_save(p, ptt.Vec.from_array(x)),
             lambda p: rviewer.vec_save(p, pt_jax.Vec.from_array(x))),
            ("tensor", lambda p: viewer.vec_save(p, torch.as_tensor(x)),
             lambda p: rviewer.vec_save(p, x)),
            ("mat", lambda p: viewer.mat_save(p, A), lambda p: rviewer.mat_save(p, R)),
            ("is", lambda p: viewer.is_save(p, IS.createGeneral(idx)),
             lambda p: rviewer.is_save(p, idx))):
        port(str(tmp_path / f"p_{what}.dat"))
        ref(str(tmp_path / f"r_{what}.dat"))
        assert _bytes(tmp_path / f"p_{what}.dat") == _bytes(tmp_path / f"r_{what}.dat"), what
    viewer.mat_save(str(tmp_path / "p.dat"), A)
    viewer.vec_save(str(tmp_path / "p.dat"), ptt.Vec.from_array(x), append=True)
    with open(tmp_path / "p.dat", "ab") as f:
        viewer.vec_save(f, ptt.Vec.from_array(2 * x))
    rviewer.mat_save(str(tmp_path / "r.dat"), R)
    rviewer.vec_save(str(tmp_path / "r.dat"), pt_jax.Vec.from_array(x), append=True)
    with open(tmp_path / "r.dat", "ab") as f:
        rviewer.vec_save(f, pt_jax.Vec.from_array(2 * x))
    assert _bytes(tmp_path / "p.dat") == _bytes(tmp_path / "r.dat")


@pytest.mark.parametrize("wide", [False, True])
def test_load_all_reads_the_references_files(tmp_path, wide):
    """load_all on a Mat, a Vec and an IS in one file; `wide`: the integers
    as 64-bit big-endian, as a build with 64-bit indices writes them."""
    _init()
    A0 = poisson2d(5)
    p = str(tmp_path / "sys.dat")
    rviewer.mat_save(p, pt_jax.MatAIJ.from_scipy(A0))
    rviewer.vec_save(p, pt_jax.Vec.from_array(np.arange(25.0)), append=True)
    rviewer.is_save(p, np.array([4, 2, 0]), append=True)
    if wide:
        raw = _bytes(p)
        ints = lambda k: np.frombuffer(raw, ">i4", count=k)  # noqa: E731
        out, off = bytearray(), 0
        for kind in ("mat", "vec", "is"):
            if kind == "mat":
                M, N, nnz = (int(t) for t in ints(off // 4 + 4)[off // 4 + 1:])
                nint, nreal = 4 + M + nnz, nnz
            elif kind == "vec":
                nint, nreal = 2, int(np.frombuffer(raw[off + 4:off + 8], ">i4")[0])
            else:
                nint, nreal = 2 + int(np.frombuffer(raw[off + 4:off + 8], ">i4")[0]), 0
            out += np.frombuffer(raw[off:off + 4 * nint], ">i4").astype(">i8").tobytes()
            off += 4 * nint
            out += raw[off:off + 8 * nreal]
            off += 8 * nreal
        with open(p, "wb") as f:
            f.write(bytes(out))
    objs = viewer.load_all(p)
    assert [type(o).__name__ for o in objs] == ["MatAIJ", "Vec", "IS"]
    assert (objs[0].to_scipy() != A0).nnz == 0
    assert np.array_equal(objs[1].getArray(), np.arange(25.0))
    assert np.array_equal(objs[2].getIndices(), [4, 2, 0])


def test_npz_checkpoints_cross_load(tmp_path):
    _init()
    A0 = poisson2d(6)
    viewer.checkpoint_save(str(tmp_path / "p.npz"), A=ptt.MatAIJ.from_scipy(A0),
                           x=ptt.Vec.from_array(np.ones(36)), t=np.array(3.5))
    rviewer.checkpoint_save(str(tmp_path / "r.npz"), A=pt_jax.MatAIJ.from_scipy(A0),
                            x=pt_jax.Vec.from_array(np.ones(36)), t=np.array(3.5))
    for load, path in ((rviewer.checkpoint_load, "p.npz"), (viewer.checkpoint_load, "r.npz"),
                       (viewer.checkpoint_load, "p.npz")):
        out = load(str(tmp_path / path))
        assert (out["A"].to_scipy() != A0).nnz == 0
        assert np.array_equal(np.asarray(out["x"].getArray())[:36], np.ones(36))
        assert out["t"] == 3.5


def test_ksp_view_solution_binary_is_the_references_file(tmp_path):
    A0 = poisson2d(8)
    b0 = np.ones(64)
    for pkg, name in ((pt_jax, "r.dat"), (ptt, "p.dat")):
        args = ["-ksp_type", "cg", "-pc_type", "none", "-ksp_rtol", "1e-30", "-ksp_max_it", "3",
                "-ksp_view_solution", f"binary:{tmp_path / name}"]
        if pkg is ptt:
            ptt.init(args=args, device="cpu")
        else:
            pt_jax.init(args=args)
        ksp = pkg.KSP().create()
        ksp.setOperators(pkg.MatAIJ.from_scipy(A0))
        ksp.setFromOptions()
        x = pkg.Vec.from_array(np.zeros(64))
        ksp.solve(pkg.Vec.from_array(b0), x)
    a, b = viewer.load(str(tmp_path / "p.dat")), viewer.load(str(tmp_path / "r.dat"))
    assert np.max(np.abs(a.getArray() - b.getArray())) <= 1e-13
