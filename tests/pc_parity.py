"""Helpers of the PC parity tests (tests/test_torch_pc_*.py): one solve in
the JAX package and the same in the port on the CPU, from the same
numpy-seeded inputs, and the comparison the tests make: iteration counts
and reasons equal; each history entry within 1e-6 of the reference's,
relative, where it lies above the rounding level, and within 1e-11 of the
initial norm where it does not (ROADMAP section 3)."""

import numpy as np
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.mat.utility import MatIS as MatIS_jax
from petsc_tpu_torch.ops.stencil_build import matis_poisson

torch.set_num_threads(1)

HIST_RTOL = 1e-6
HIST_ATOL_OF_INITIAL = 1e-11


def make(pkg, A_sp=None, matis=None, grid=None, bs=None):
    if matis is not None:
        mats, maps, n = matis
        cls = ptt.MatIS if pkg is ptt else MatIS_jax
        return cls.create(n, mats, maps)
    A = pkg.MatAIJ.from_scipy(A_sp)
    if grid is not None:
        A.setStencilGrid(grid)
    if bs is not None:
        A.setBlockSize(bs)
    return A


def solve(pkg, args, A_sp=None, b=None, setup=None, matis=None, grid=None, bs=None,
          ksp_type=None, pc_type=None, tol=None, norm=None):
    """(its, reason, history, x) of one solve; `setup(pc)` runs after the
    PC's type is set and before the solve."""
    if pkg is ptt:
        ptt.init(args=list(args), device="cpu")
    else:
        pt_jax.init(args=list(args))
    A = make(pkg, A_sp, matis, grid, bs)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    if ksp_type:
        ksp.setType(ksp_type)
    if pc_type:
        ksp.getPC().setType(pc_type)
    if tol is not None:
        ksp.setTolerances(**tol)
    if norm:
        ksp.setNormType(norm)
    ksp.setFromOptions()
    if setup is not None:
        setup(ksp.getPC())
    n = A.getSize()[0]
    bb = np.ones(n) if b is None else b
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(bb), x)
    xa = x.array.cpu().numpy() if pkg is ptt else np.asarray(x.getArray())
    return (ksp.getIterationNumber(), ksp.getConvergedReason().name,
            np.asarray(ksp.getConvergenceHistory()), xa[:n], ksp)


def assert_parity(port, ref, label=""):
    its, reason, h = port[:3]
    its_r, reason_r, h_r = ref[:3]
    assert (its, reason) == (its_r, reason_r), (label, its, reason, its_r, reason_r)
    assert len(h) == len(h_r), label
    if not len(h_r):             # preonly: no history, the solutions instead
        x, x_r = port[3], ref[3]
        assert np.max(np.abs(x - x_r)) <= 1e-10 * np.max(np.abs(x_r)), label
        return
    bound = HIST_RTOL * np.abs(h_r) + HIST_ATOL_OF_INITIAL * h_r[0]
    assert np.all(np.abs(h - h_r) <= bound), (label, np.max(np.abs(h - h_r) / np.abs(h_r)))


def both(args, **kw):
    """The port's and the reference's solve of one case, held to parity."""
    port = solve(ptt, args, **kw)
    ref = solve(pt_jax, args, **kw)
    assert_parity(port, ref, str(args))
    return port, ref


def matis_case(ne, nsub):
    """The ex59-class MatIS (stencil_build.matis_poisson) and a seeded b."""
    mats, maps, n = matis_poisson(ne, nsub)
    return (mats, maps, n), np.random.default_rng(7).random(n)


def run_both(pc_type, A_sp, ksp_type="gmres", setup=None, rtol=1e-8, max_it=300, args=()):
    """The reference tests' run() (tests/test_more_pc.py) in both packages:
    b = A u for u uniform from seed 5; setup(pc, pkg) after the types."""
    u = np.random.default_rng(5).random(A_sp.shape[0])
    b = A_sp @ u
    out = []
    for pkg in (ptt, pt_jax):
        out.append(solve(pkg, args, A_sp=A_sp, b=b, ksp_type=ksp_type, pc_type=pc_type,
                         tol={"rtol": rtol, "max_it": max_it},
                         setup=None if setup is None else (lambda pc, p=pkg: setup(pc, p))))
    assert_parity(out[0], out[1], pc_type)
    return out
