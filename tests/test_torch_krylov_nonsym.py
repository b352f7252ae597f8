"""petsc_tpu_torch's Krylov types for non-symmetric systems against the JAX
package: BASELINE config 2's stencil7 (jittered, not symmetric) assembled
at 6 x 60 x 60 (chip_smoke.CONFIG2_SMALL), ILU(0) with
-pc_factor_transpose_solve, b = A cos(0.01 i), x0 = 0, both packages
driven through their user API with the same options.

Tolerances: iteration counts and converged reasons are equal; residual
histories agree to 1e-6 relative (the two packages sum in other orders)
and solutions to 1e-7 of the largest entry. The aliases (pgmres,
pipefgmres, fbcgs, fbcgsr, pipebcgs, pipegcr, agmres) are cases of one
parametrised test beside their base types."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import stencil_build

torch.set_num_threads(1)

HIST_TOL = 1e-6
BASE = ["-ksp_rtol", "1e-8", "-ksp_max_it", "400", "-pc_factor_transpose_solve"]


def stencil7(shape):
    i, j, v = stencil_build.stencil7_coo(*shape)
    n = int(np.prod(shape))
    return sp.csr_matrix((v, (i, j)), shape=(n, n))


def solve(pkg, A_sp, args, b, grid=None, radius=None, device=None):
    """One solve through the package's API; returns (ksp, x as numpy)."""
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
    if radius is not None:
        ksp.setRadius(radius)
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(b), x)
    xa = x.getArray() if pkg is pt_jax else x.array.cpu().numpy()
    return ksp, np.asarray(xa)[:A_sp.shape[0]]


def both(A_sp, args, **kw):
    b = A_sp @ np.cos(0.01 * np.arange(A_sp.shape[0]))
    return solve(pt_jax, A_sp, args, b, **kw), solve(ptt, A_sp, args, b, device="cpu", **kw)


def agree(j, p, hist_tol=HIST_TOL, x_tol=1e-7):
    (kj, xj), (kp, xp) = j, p
    assert kp.getType() == kj.getType() and kp.getPC().getType() == kj.getPC().getType()
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert len(hp) == len(hj)
    np.testing.assert_allclose(hp, hj, rtol=hist_tol, atol=0)
    np.testing.assert_allclose(xp, xj, rtol=0, atol=x_tol * np.abs(xj).max())


@pytest.fixture(scope="module")
def config2_small():
    return stencil7(chip_smoke.CONFIG2_SMALL)


CASES = {
    "cgs": [], "tfqmr": [], "bcgsl": [], "bcgsl, ell 3": ["-ksp_bcgsl_ell", "3"],
    "ibcgs": [], "idr": [], "idr, s 2": ["-ksp_idr_s", "2"],
    "lgmres": [], "lgmres, restart 6, augment 3": ["-ksp_gmres_restart", "6",
                                                  "-ksp_lgmres_augment", "3"],
    "dgmres, restart 4": ["-ksp_gmres_restart", "4"], "gcr": [],
    "gcr, restart 4": ["-ksp_gmres_restart", "4"], "tcqmr": [], "qmrcgs": [],
    "bicg": [], "tsirm": [], "lcd": [],
}


@pytest.mark.parametrize("name", CASES)
def test_nonsymmetric_types_match_the_reference(name, config2_small):
    t = name.split(",")[0]
    j, p = both(config2_small, BASE + ["-ksp_type", t, *CASES[name]])
    agree(j, p)
    assert p[0].getConvergedReason() == ptt.KSPConvergedReason.CONVERGED_RTOL


ALIASES = {"pgmres": "gmres", "pipefgmres": "fgmres", "fbcgs": "bcgs", "fbcgsr": "bcgs",
           "pipebcgs": "bcgs", "pipegcr": "gcr", "agmres": "dgmres"}


@pytest.mark.parametrize("alias", ALIASES)
def test_aliases_match_the_reference_and_their_base_type(alias, config2_small):
    extra = ["-ksp_gmres_restart", "5"] if alias == "agmres" else []
    j, p = both(config2_small, BASE + ["-ksp_type", alias, *extra])
    agree(j, p)
    base = solve(ptt, config2_small, BASE + ["-ksp_type", ALIASES[alias], *extra],
                 config2_small @ np.cos(0.01 * np.arange(config2_small.shape[0])),
                 device="cpu")
    np.testing.assert_array_equal(base[0].getConvergenceHistory(),
                                  p[0].getConvergenceHistory())
