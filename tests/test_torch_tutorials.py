"""The port's copies of PETSc's ex1 and ex2 tutorials, on the CPU, against
the reference's pinned expected outputs and against the JAX package's run
of the same example with the same arguments (tests/test_tutorials_ksp.py's
cases whose solvers are ported: GMRES + ILU, BiCGStab, CG + Jacobi,
preonly + LU and Cholesky, block Jacobi with ILU and LU blocks, a forced
GMRES restart, GMRES + symmetric SOR, and ex1's two solves), and
tests/test_examples_all.py's ex1, ex2 and ex45 rows on the port.

Tolerances: the pinned texts as tests/test_tutorials_ksp.py holds them
(1e-3, or 1e-6 for the SOR case); the reference's run to 1e-6 relative on
every number, with an absolute slack of 1e-12 for error norms at rounding
level."""

import sys
from pathlib import Path

import pytest
import torch

from petsc_tpu.utils.testing import run_example as run_jax
from petsc_tpu_torch.examples import ex1, ex2, ex45
from petsc_tpu_torch.utils.testing import assert_output, diff_output, run_example

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from examples import ex1 as ex1_jax  # noqa: E402
from examples import ex2 as ex2_jax  # noqa: E402

torch.set_num_threads(1)

# the reference's output/ex2_1.out
EX2_1 = """\
  0 KSP Residual norm 3.21109
  1 KSP Residual norm 0.93268
  2 KSP Residual norm 0.103515
  3 KSP Residual norm 0.00787798
  4 KSP Residual norm 0.000387275
Norm of error 0.000392701 iterations 4
"""

# the reference's output/ex2_3.out (-pc_type sor -pc_sor_symmetric, 8 x 7)
EX2_3 = """\
  0 KSP Residual norm 2.98499
  1 KSP Residual norm 1.13133
  2 KSP Residual norm 0.575925
  3 KSP Residual norm 0.108871
  4 KSP Residual norm 0.0213225
  5 KSP Residual norm 0.00325239
  6 KSP Residual norm 0.000874208
  7 KSP Residual norm 0.000179613
Norm of error 0.000300302 iterations 7
"""

# the reference's output/ex1_1.out (both solves)
EX1_1 = """\
  0 KSP Residual norm 0.707107
  1 KSP Residual norm 0.316228
  2 KSP Residual norm 0.188982
  3 KSP Residual norm 0.129099
  4 KSP Residual norm 0.0953463
  5 KSP Residual norm < 1.e-11
Norm of error 2.99143e-15, Iterations 5
  0 KSP Residual norm 0.353553
  1 KSP Residual norm 0.0857493
  2 KSP Residual norm 0.0227273
  3 KSP Residual norm 0.0060831
  4 KSP Residual norm 0.0016298
  5 KSP Residual norm < 1.e-11
"""


def _port(main, args):
    return run_example(main, args, device="cpu")


def _norm_its(out):
    line = [ln for ln in out.splitlines() if ln.startswith("Norm")][0]
    return float(line.split()[3].rstrip(",")), int(line.split()[-1])


def test_ex2_gmres_ilu_reference_parity():
    out = _port(ex2.main, "-m 5 -n 5 -ksp_monitor_short "
                          "-ksp_gmres_cgs_refinement_type refine_always")
    assert_output(out, EX2_1, rtol=1e-3)


# (name, arguments, the reference test's own check on (error norm, its));
# GMRES(5) on 12 x 12 runs about 116 iterations, where the two packages'
# different summation orders compound: their histories agree to 1e-12 for
# the first 50 iterations and drift apart after about 64 (a few per cent at
# the end, 116 or 117 iterations), so that case holds the first 50 lines
CASES = [
    ("default_size_gmres_ilu", "", lambda e, i: e < 1e-3),
    ("bcgs", "-ksp_type bcgs -m 5 -n 5", lambda e, i: e < 5e-3),
    ("cg_jacobi", "-ksp_type cg -pc_type jacobi -m 9 -n 9 -ksp_rtol 1e-10",
     lambda e, i: e < 1e-7),
    ("lu_preonly", "-ksp_type preonly -pc_type lu -m 6 -n 5", lambda e, i: e < 1e-10 and i == 1),
    ("cholesky", "-ksp_type preonly -pc_type cholesky -m 4 -n 4", lambda e, i: e < 1e-10),
    ("bjacobi_ilu", "-pc_type bjacobi -pc_bjacobi_blocks 4 -m 8 -n 8 -ksp_rtol 1e-8",
     lambda e, i: e < 1e-5),
    ("bjacobi_sub_lu", "-pc_type bjacobi -pc_bjacobi_blocks 2 -sub_pc_type lu -m 8 -n 8 "
                       "-ksp_rtol 1e-8", lambda e, i: e < 1e-5),
    ("gmres_restart", "-m 12 -n 12 -ksp_gmres_restart 5 -pc_type jacobi -ksp_rtol 1e-8",
     lambda e, i: e < 1e-4),
]


@pytest.mark.parametrize("name,args,check", CASES, ids=[c[0] for c in CASES])
def test_ex2_against_the_reference_run(name, args, check):
    """The reference test's check, and the port's whole output (with the
    residual monitor) equal to the JAX package's run of ex2 (the restart
    case: its first 50 lines)."""
    args = args + " -ksp_monitor_short"
    out = _port(ex2.main, args)
    want = run_jax(ex2_jax.main, args)
    assert check(*_norm_its(out))
    if name == "gmres_restart":
        out, want = ("\n".join(t.splitlines()[:50]) for t in (out, want))
    assert_output(out, want, rtol=1e-6, atol=1e-12)


def test_ex2_3_sor_reference_parity():
    out = _port(ex2.main, "-pc_type sor -pc_sor_symmetric -ksp_monitor_short "
                          "-ksp_gmres_cgs_refinement_type refine_always")
    assert_output(out, EX2_3, rtol=1e-6)


def test_ex1_tridiagonal_reference_parity():
    out = _port(ex1.main, "-ksp_monitor_short -ksp_gmres_cgs_refinement_type refine_always")
    # the error norm is at rounding level: an absolute slack there
    assert_output(out, EX1_1, rtol=1e-3, atol=1e-13)


def test_ex1_ksp_view_against_the_reference_run():
    args = "-ksp_view"
    assert_output(_port(ex1.main, args), run_jax(ex1_jax.main, args), rtol=1e-6, atol=1e-13)


def test_diff_output_reports_mismatches():
    assert diff_output("a 1.0\nb", "a 1.0\nb") == []
    assert "line count" in diff_output("a 1.0", "a 1.0\nb")[0]
    assert "number" in diff_output("a 1.1", "a 1.0")[0]
    assert "!=" in diff_output("a 1.0", "c 1.0")[0]
    with pytest.raises(AssertionError, match="output mismatch"):
        assert_output("x 2", "x 1")


# tests/test_examples_all.py's rows of the ported examples
EXAMPLES = [
    (ex1, []),
    (ex2, ["-m", "5", "-n", "5"]),
    (ex45, ["-da_grid_x", "9", "-da_grid_y", "9", "-da_grid_z", "9"]),
]


@pytest.mark.parametrize("mod,args", EXAMPLES, ids=["ex1", "ex2", "ex45"])
def test_example_runs(mod, args):
    mod.main(list(args), device="cpu")
