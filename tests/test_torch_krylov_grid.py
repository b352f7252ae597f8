"""The transpose product of a grid operator (V1T) and the solvers that use
it, against the JAX package.

V1T's plain version (the gather form ops.grid_kernels.dnd_stencil_t) is
held to the reference's scatter-form mult_t (mat/aij.py:1438-1451) to 1e-12
relative on random-coefficient star7 and box27 grids, and V1's plain
version on the transposed stencil (what V1T launches on the card) to the
gather form bit for bit. bicg + jacobi, cgls, lsqr and cgne on config 2's
stencil7 declared on its 6 x 60 x 60 grid (aij_dnd in both packages)
match the reference's iterations, reason and history (1e-6 relative).
BiCG with a PC that has no transpose raises where the reference applies B
in place of B^T and runs to DIVERGED_ITS; with -pc_factor_transpose_solve
it takes the reference's iterations."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.ops import operator as op_jax
from petsc_tpu_torch.ops import grid_kernels as gk
from petsc_tpu_torch.sys.error import Error

torch.set_num_threads(1)

HIST_TOL = 1e-6


def random_grid_matrix(shape, box, seed):
    """A random-coefficient stencil on `shape` (star7 or box27 offsets,
    neighbours outside the grid dropped) as a scipy CSR."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows, cols = [], []
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
            if box or abs(a) + abs(b) + abs(c) <= 1]
    for o in offs:
        src = tuple(slice(max(0, -d), s - max(0, d)) for d, s in zip(o, shape))
        dst = tuple(slice(max(0, d), s - max(0, -d)) for d, s in zip(o, shape))
        rows.append(idx[src].ravel())
        cols.append(idx[dst].ravel())
    r, c = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((rng.standard_normal(len(r)), (r, c)), shape=(n, n))


@pytest.mark.parametrize("box", [False, True], ids=["star7", "box27"])
def test_v1t_plain_matches_the_reference_mult_t(box):
    shape = (5, 6, 7)
    A_sp = random_grid_matrix(shape, box, seed=3 + box)
    n = A_sp.shape[0]
    x = np.random.default_rng(9).standard_normal(n)
    pt_jax.init()
    Aj = pt_jax.MatAIJ.from_scipy(A_sp)
    Aj.setStencilGrid(shape)
    yj = np.asarray(op_jax.bind(Aj.meta, Aj.device_data()).mult_t(
        pt_jax.Vec.from_array(x).array))[:n]
    ptt.init(device="cpu")
    Ap = ptt.MatAIJ.from_scipy(A_sp)
    Ap.setStencilGrid(shape)
    assert Ap.meta[0] == "aij_dnd"
    yp = Ap.op().mult_t(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(yp, yj, rtol=0, atol=1e-12 * np.abs(yj).max())
    np.testing.assert_allclose(yp, A_sp.T @ x, rtol=0, atol=1e-12 * np.abs(yj).max())
    # V1's plain version on the transposed stencil: what V1T runs on the card
    meta, data = Ap.meta, Ap.device_data()
    consts = meta[6] if len(meta) > 6 else (None,) * len(meta[2])
    offs_t, planes = gk.transposed_stencil(meta[1], meta[2], consts, data["coef"])
    y1 = gk.dnd_stencil_plain(torch.as_tensor(x), meta[1], offs_t, consts, planes)
    assert torch.equal(y1, torch.as_tensor(yp))


def test_v1t_follows_new_values():
    shape = (4, 5, 6)
    A_sp = random_grid_matrix(shape, False, seed=1)
    ptt.init(device="cpu")
    A = ptt.MatAIJ()
    A.setSizes(A_sp.shape[0])
    A.setStencilGrid(shape)
    coo = A_sp.tocoo()
    A.setPreallocationCOO(coo.row, coo.col)
    A.setValuesCOO(coo.data)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(A_sp.shape[0]))
    np.testing.assert_allclose(A.op().mult_t(x).numpy(), A_sp.T @ x.numpy(), atol=1e-13)
    A.setValuesCOO(2.0 * coo.data)
    np.testing.assert_allclose(A.op().mult_t(x).numpy(), 2.0 * (A_sp.T @ x.numpy()),
                               atol=1e-13)


def stencil7(shape):
    from petsc_tpu_torch.ops import stencil_build
    i, j, v = stencil_build.stencil7_coo(*shape)
    n = int(np.prod(shape))
    return sp.csr_matrix((v, (i, j)), shape=(n, n))


def solve(pkg, A_sp, args, grid=None, device=None):
    if device is None:
        pkg.init(args=args)
    else:
        pkg.init(args=args, device=device)
    A = pkg.MatAIJ.from_scipy(A_sp)
    if grid is not None:
        A.setStencilGrid(grid)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A_sp @ np.cos(0.01 * np.arange(A_sp.shape[0]))
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(b), x)
    xa = x.getArray() if pkg is pt_jax else x.array.cpu().numpy()
    return ksp, np.asarray(xa)[:A_sp.shape[0]], A


@pytest.mark.parametrize("ksp_type, pc", [("bicg", "jacobi"), ("cgls", "none"),
                                          ("lsqr", "none"), ("cgne", "none")])
def test_transpose_solvers_on_the_grid_match_the_reference(ksp_type, pc):
    shape = chip_smoke.CONFIG2_SMALL
    A_sp = stencil7(shape)
    args = ["-ksp_rtol", "1e-8", "-ksp_max_it", "400", "-ksp_type", ksp_type, "-pc_type", pc]
    kj, xj, _ = solve(pt_jax, A_sp, args, grid=shape)
    kp, xp, Ap = solve(ptt, A_sp, args, grid=shape, device="cpu")
    assert Ap.meta[0] == "aij_dnd"
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"
    np.testing.assert_allclose(kp.getConvergenceHistory(), kj.getConvergenceHistory(),
                               rtol=HIST_TOL, atol=0)
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-7 * np.abs(xj).max())


def convective7(shape, c=0.3):
    """The 7-point Laplacian (6 / -1) with central convection c along x:
    -1 + c to the x + 1 neighbour, -1 - c to the x - 1 one."""
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        for s in (-1, 1):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            src[ax] = slice(max(0, -s), shape[ax] - max(0, s))
            dst[ax] = slice(max(0, s), shape[ax] - max(0, -s))
            r = idx[tuple(src)].ravel()
            rows.append(r)
            cols.append(idx[tuple(dst)].ravel())
            vals.append(np.full(len(r), -1.0 + (c * s if ax == 2 else 0.0)))
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def bicg(pkg, A_sp, extra, device=None):
    args = ["-ksp_type", "bicg", "-ksp_rtol", "1e-8", *extra]
    if device is None:
        pkg.init(args=args)
    else:
        pkg.init(args=args, device=device)
    A = pkg.MatAIJ.from_scipy(A_sp)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(np.cos(0.01 * np.arange(A_sp.shape[0]))), x)
    return ksp


def test_bicg_needs_the_pc_transpose():
    """ILU without -pc_factor_transpose_solve has no transpose: the port
    raises, naming the option; the reference applies B for B^T and on the
    6 x 8 x 8 convective stencil runs to its 10000 iterations, DIVERGED_ITS,
    its residual flat at 114.67 (ROADMAP section 3). With the option both
    take 13 iterations."""
    A_sp = convective7((6, 8, 8))
    kj = bicg(pt_jax, A_sp, [])
    assert kj.getConvergedReason().name == "DIVERGED_ITS"
    assert kj.getIterationNumber() == 10000
    assert abs(kj.getConvergenceHistory()[-1] - 114.67) < 0.01
    with pytest.raises(Error, match="-pc_factor_transpose_solve"):
        bicg(ptt, A_sp, [], device="cpu")
    kj = bicg(pt_jax, A_sp, ["-pc_factor_transpose_solve"])
    kp = bicg(ptt, A_sp, ["-pc_factor_transpose_solve"], device="cpu")
    assert kp.getIterationNumber() == kj.getIterationNumber() == 13
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"
    np.testing.assert_allclose(kp.getConvergenceHistory(), kj.getConvergenceHistory(),
                               rtol=HIST_TOL, atol=0)
