"""The Neumann trisolve, bjacobi with an iterative sub-KSP and classical
and geometric GAMG against the JAX package on the CPU, on the reference
tests' inputs (tests/test_trisolve_neumann.py, tests/test_gamg_classical.py,
tests/test_tutorials_ksp.py's bjacobi and PCKSP cases): iteration counts
and reasons equal, histories to 1e-6 relative (rounding-level entries to
1e-11 of the initial norm), the applications to 1e-11."""

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.pc.gamg import mis_aggregate as mis_jax
from petsc_tpu.pc.gamg_classical import (classical_direct_prolongator as direct_jax,
                                         classical_standard_prolongator as standard_jax,
                                         classical_strength as strength_jax)
from petsc_tpu_torch.examples import ex2
from petsc_tpu_torch.pc import gamg_classical as gc
from petsc_tpu_torch.utils.testing import assert_output, run_example
from tests.pc_parity import assert_parity, both, solve
from tests.test_mg_gamg import poisson2d, poisson3d
from tests.test_trisolve_neumann import _A3d

from petsc_tpu.utils.testing import run_example as run_jax
from examples import ex2 as ex2_jax


@pytest.mark.parametrize("sweeps, grid", [(4, True), (8, True), (6, False)])
def test_neumann_gmres_matches_the_reference(sweeps, grid):
    A, n = _A3d(10)
    args = ["-ksp_type", "gmres", "-pc_type", "ilu", "-pc_factor_trisolve", "neumann",
            "-pc_factor_trisolve_sweeps", str(sweeps), "-ksp_rtol", "1e-10", "-ksp_max_it", "300"]
    port, _ = both(args, A_sp=A, b=A @ np.ones(A.shape[0]), grid=(n, n, n) if grid else None)
    meta = port[4].getPC().meta
    assert meta[0] == "pc_trisolve_neumann"
    assert meta[1][0] == ("aij_dnd" if grid else "aij_csr")


def test_neumann_at_the_depth_is_the_exact_trisolve_and_its_transpose():
    A, n = _A3d(6)
    x = torch.as_tensor(np.random.default_rng(0).random(A.shape[0]))
    ops = {}
    for mode in ("neumann", "levels"):
        ptt.init(args=["-pc_factor_trisolve", mode, "-pc_factor_trisolve_sweeps", str(3 * 6),
                       "-pc_factor_transpose_solve"], device="cpu")
        M = ptt.MatAIJ.from_scipy(A)
        M.setStencilGrid((n, n, n))
        pc = ptt.PC().create()
        pc.setOperators(M)
        pc.setType("ilu")
        pc.setFromOptions()
        ops[mode] = pc.op()
    for f in ("mult", "mult_t"):
        z1, z2 = getattr(ops["neumann"], f)(x), getattr(ops["levels"], f)(x)
        assert float((z1 - z2).abs().max()) <= 1e-11 * float(z2.abs().max()), f


def test_bjacobi_sub_ksp_matches_the_reference():
    args = ["-ksp_type", "fgmres", "-pc_type", "bjacobi", "-pc_bjacobi_blocks", "4",
            "-sub_ksp_type", "gmres", "-sub_pc_type", "jacobi", "-ksp_rtol", "1e-8"]
    port, _ = both(args, A_sp=poisson2d(16))
    inner = port[4].getPC()._impl.sub_ksp
    assert (inner.getType(), inner.max_it) == ("gmres", 50)   # PETSc's 10000 cut to 50


def test_bjacobi_sub_ksp_with_a_factor_sub_pc_is_the_factor_as_in_the_reference():
    """The reference reaches the sub-KSP only for a sub-PC other than
    ilu, icc, lu and cholesky (ROADMAP section 3): -sub_ksp_type gmres with
    -sub_pc_type ilu is bjacobi + ILU(0), with no inner loop."""
    args = ["-ksp_type", "fgmres", "-pc_type", "bjacobi", "-pc_bjacobi_blocks", "4",
            "-sub_ksp_type", "gmres", "-sub_pc_type", "ilu", "-ksp_rtol", "1e-8"]
    port, _ = both(args, A_sp=poisson2d(16))
    assert port[4].getPC().meta[0] == "pc_trisolve"


@pytest.mark.parametrize("name, args", [
    ("bjacobi_3", "-pc_type bjacobi -pc_bjacobi_blocks 4 -sub_pc_type jacobi -sub_ksp_type gmres "
                  "-ksp_gmres_cgs_refinement_type refine_always"),
    ("pcksp_chebyshev", "-m 20 -n 20 -ksp_pc_side right -pc_type ksp -ksp_ksp_type chebyshev "
                        "-ksp_ksp_max_it 5 -ksp_ksp_chebyshev_esteig 0.9,0,0,1.1"),
    ("eisenstat", "-pc_type eisenstat -m 8 -n 8 -ksp_rtol 1e-8")])
def test_ex2_with_the_new_pcs_against_the_reference_run(name, args):
    args = args + " -ksp_monitor_short"
    out = run_example(ex2.main, args, device="cpu")
    want = run_jax(ex2_jax.main, args)
    assert_output(out, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("maker, n", [(poisson2d, 20), (poisson3d, 8)])
def test_classical_pieces_equal_the_reference(maker, n):
    A = maker(n)
    for theta in (0.0, 0.25):
        G, Gj = gc.classical_strength(A, theta), strength_jax(A, theta)
        assert (G != Gj).nnz == 0
        _, _, roots = mis_jax(Gj)
        for mine, ref in ((gc.classical_direct_prolongator, direct_jax),
                          (gc.classical_standard_prolongator, standard_jax)):
            assert abs(mine(A, roots, theta) - ref(A, roots, theta)).max() == 0


@pytest.mark.parametrize("ctype, nsmooths, maker, n", [
    ("direct", 0, poisson2d, 24), ("standard", 0, poisson2d, 24), ("direct", 1, poisson3d, 10)])
def test_classical_gamg_matches_the_reference(ctype, nsmooths, maker, n):
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-pc_gamg_type", "classical",
            "-pc_gamg_classical_type", ctype, "-pc_gamg_classical_nsmooths", str(nsmooths),
            "-ksp_rtol", "1e-8"]
    port, _ = both(args, A_sp=maker(n))
    levels = port[4].getPC()._impl.levels
    assert len(levels) > 2 and all(lev.A.meta[0] == "aij_csr" for lev in levels)


def test_geo_gamg_matches_the_reference():
    n = 32
    xy = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  axis=-1).reshape(-1, 2) * 1.0
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-pc_gamg_type", "geo", "-ksp_rtol", "1e-8"]
    A = poisson2d(n)
    out = []
    for pkg in (ptt, pt_jax):
        if pkg is ptt:
            ptt.init(args=args, device="cpu")
        else:
            pt_jax.init(args=args)
        M = pkg.MatAIJ.from_scipy(A)
        ksp = pkg.KSP().create()
        ksp.setOperators(M)
        ksp.getPC().setCoordinates(xy)
        ksp.setFromOptions()
        b = M.createVecLeft()
        b.set(1.0)
        x = M.createVecRight()
        ksp.solve(b, x)
        out.append((ksp.getIterationNumber(), ksp.getConvergedReason().name,
                    np.asarray(ksp.getConvergenceHistory())))
    assert_parity(*out)
