"""petsc_tpu_torch's Krylov types for symmetric systems against the JAX
package: the 27-point box (26 / -1) on a 16^3 grid as the stencil operator
(build_dnd + as_mat, S1's plain version here), -pc_type jacobi, rtol 1e-8,
b = 1, x0 = 0, both packages through their user API.

Tolerances: iteration counts and converged reasons are equal; residual
histories agree to 1e-6 relative and solutions to 1e-7 of the largest
entry. The trust-region types take setRadius(270), which stops them on
the boundary after a few steps (CONVERGED_STEP_LENGTH; gltr then solves
its tridiagonal subproblem and replays the Lanczos vectors), and no
radius, which is CG. The pipelined aliases are cases of one parametrised
test beside their base types."""

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.ops import stencil_build as sb_jax
from petsc_tpu_torch.ops import stencil_build as sb_torch

torch.set_num_threads(1)

HIST_TOL = 1e-6
N = 16
RADIUS = 270.0


def solve(pkg, args, radius=None, device=None):
    if device is None:
        pkg.init(args=args)
    else:
        pkg.init(args=args, device=device)
    sb = sb_torch if pkg is ptt else sb_jax
    A = sb.as_mat(*sb.build_dnd((N,) * 3, kind="box"))
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    if radius is not None:
        ksp.setRadius(radius)
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    xa = x.getArray() if pkg is pt_jax else x.array.cpu().numpy()
    return ksp, np.asarray(xa)[:N ** 3]


def both(ksp_type, radius=None, extra=()):
    args = ["-ksp_type", ksp_type, "-pc_type", "jacobi", "-ksp_rtol", "1e-8",
            "-ksp_max_it", "3000", *extra]
    return solve(pt_jax, args, radius), solve(ptt, args, radius, device="cpu")


def agree(j, p):
    (kj, xj), (kp, xp) = j, p
    assert kp.getIterationNumber() == kj.getIterationNumber()
    assert kp.getConvergedReason().name == kj.getConvergedReason().name
    hj, hp = kj.getConvergenceHistory(), kp.getConvergenceHistory()
    assert len(hp) == len(hj)
    np.testing.assert_allclose(hp, hj, rtol=HIST_TOL, atol=0)
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-7 * np.abs(xj).max())


@pytest.mark.parametrize("ksp_type", ["cr", "fcg", "pipecg", "symmlq", "lcd"])
def test_symmetric_types_match_the_reference(ksp_type):
    j, p = both(ksp_type)
    agree(j, p)
    assert p[0].getConvergedReason() == ptt.KSPConvergedReason.CONVERGED_RTOL


ALIASES = {"pipecr": "cr", "pipefcg": "fcg", "pipecg2": "pipecg", "pipecgrr": "pipecg",
           "pipelcg": "pipecg", "pipeprcg": "pipecg", "groppcg": "pipecg"}


@pytest.mark.parametrize("alias", ALIASES)
def test_pipelined_aliases_match_the_reference_and_their_base_type(alias):
    j, p = both(alias)
    agree(j, p)
    base = solve(ptt, ["-ksp_type", ALIASES[alias], "-pc_type", "jacobi", "-ksp_rtol",
                       "1e-8", "-ksp_max_it", "3000"], device="cpu")
    np.testing.assert_array_equal(base[0].getConvergenceHistory(),
                                  p[0].getConvergenceHistory())


@pytest.mark.parametrize("ksp_type", ["stcg", "nash", "qcg", "gltr"])
@pytest.mark.parametrize("radius", [RADIUS, None])
def test_trust_region_types_match_the_reference(ksp_type, radius):
    j, p = both(ksp_type, radius)
    agree(j, p)
    want = "CONVERGED_STEP_LENGTH" if radius else "CONVERGED_RTOL"
    assert p[0].getConvergedReason().name == want
    if radius:
        assert 1 < p[0].getIterationNumber() < 24


def test_fcg_takes_max_it_as_petsc_does():
    """The port stops fcg at max_it (PETSc's KSPSolve contract). The
    reference's loop tests ||r|| against max_it instead (impls_more.py:486):
    with max_it 30 it takes no step, its 0 and reason 0 (ITERATING), since
    ||b|| = 64 is above 30 (ROADMAP section 3)."""
    args = ["-ksp_type", "fcg", "-pc_type", "jacobi", "-ksp_rtol", "1e-8",
            "-ksp_max_it", "30"]
    kj, _ = solve(pt_jax, args)
    kp, _ = solve(ptt, args, device="cpu")
    assert kp.getIterationNumber() == 24
    assert kp.getConvergedReason() == ptt.KSPConvergedReason.CONVERGED_RTOL
    assert kj.getIterationNumber() == 0 and int(kj.getConvergedReason()) == 0
    kp2, _ = solve(ptt, args[:-1] + ["10"], device="cpu")
    assert kp2.getIterationNumber() == 10
    assert kp2.getConvergedReason() == ptt.KSPConvergedReason.DIVERGED_ITS
