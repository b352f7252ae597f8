"""The KSP surface around the Krylov types, against the JAX package: the
registry (every name of the reference's, with its default norm and
flags), KSPGuess (Fischer and POD) over two solves, mixed-precision
iterative refinement (setMixedPrecision and -ksp_mixed_precision), and
the options -ksp_bcgsl_ell, -ksp_idr_s and -ksp_lgmres_augment.

Tolerances: iteration counts and reasons equal; f64 histories to 1e-6
relative. The refinement: the first pass's inner its equal to the
reference's (both solve the same f32 right-hand side), the initial norm
to 1e-6 relative, each later outer norm within chip_smoke.KRYLOV_IR_FACTOR
of the reference's: after the first pass each outer norm is the f32
inner solve's own rounding error (`python krylov_contract.py NZ NY NX
passes` shows it)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import krylov_contract
import petsc_tpu as pt_jax
import petsc_tpu.ksp.ksp as ksp_jax
import petsc_tpu_torch as ptt
import petsc_tpu_torch.ksp.ksp as ksp_torch
from petsc_tpu_torch.ops import stencil_build

torch.set_num_threads(1)


def stencil7(shape):
    i, j, v = stencil_build.stencil7_coo(*shape)
    n = int(np.prod(shape))
    return sp.csr_matrix((v, (i, j)), shape=(n, n))


def test_every_reference_type_but_fetidp_is_registered_alike():
    """Every KSP type of the reference, fetidp now among them, with its
    default norm and flags."""
    ref, port = ksp_jax._IMPLS, ksp_torch._IMPLS
    assert set(ref) == set(port)
    for name, r in ref.items():
        p = port[name]
        assert (p["norm"], p["right"], p["host_driven"]) == \
            (r["norm"], r["right"], r["host_driven"]), name
        assert (p["extras"] is None) == (r["extras"] is None), name


def make_ksp(pkg, A_sp, args, device=None):
    if device is None:
        pkg.init(args=args)
    else:
        pkg.init(args=args, device=device)
    A = pkg.MatAIJ.from_scipy(A_sp)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    return ksp, A


def run(pkg, ksp, A, b):
    x = A.createVecRight()
    ksp.solve(pkg.Vec.from_array(b), x)
    xa = x.getArray() if pkg is pt_jax else x.array.cpu().numpy()
    return (ksp.getIterationNumber(), ksp.getConvergedReason().name,
            ksp.getConvergenceHistory(), np.asarray(xa)[:len(b)])


def guess_rhs(A_sp, count):
    """count nearby right-hand sides A (cos(0.01 i) + 0.01 sin(0.05 k i)),
    each with a new frequency, so that no few solutions span the next."""
    i = np.arange(A_sp.shape[0])
    return [A_sp @ (np.cos(0.01 * i) + 0.01 * np.sin(0.05 * k * i)) for k in range(count)]


@pytest.mark.parametrize("kind, size, count", [("fischer", 4, 2), ("pod", 4, 2),
                                               ("fischer", 2, 5), ("pod", 2, 5)])
def test_guess_over_solves_matches_the_reference(kind, size, count):
    """Solves with the same operator and nearby right-hand sides: each
    after the first starts from the guess of the earlier solutions, in
    both packages the same iterations and history; with more solves than
    the guess keeps, the oldest is dropped."""
    A_sp = stencil7((4, 10, 10))
    args = ["-ksp_type", "gmres", "-pc_type", "jacobi", "-ksp_rtol", "1e-8"]
    out = {}
    for pkg, dev in ((pt_jax, None), (ptt, "cpu")):
        ksp, A = make_ksp(pkg, A_sp, args, dev)
        ksp.setGuessType(kind, size)
        out[pkg] = [run(pkg, ksp, A, b) for b in guess_rhs(A_sp, count)]
    for (ij, rj, hj, xj), (ip, rp, hp, xp) in zip(out[pt_jax], out[ptt]):
        assert (ip, rp) == (ij, rj)
        np.testing.assert_allclose(hp, hj, rtol=1e-6, atol=0)
        np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-7 * np.abs(xj).max())
    # the second solve starts from the guess: its initial norm far below the first's
    assert out[ptt][1][2][0] < 0.05 * out[ptt][0][2][0]


def test_guess_solve_time_is_taken_before_the_update(monkeypatch):
    """KSPSolve's logged time ends before the guess's update (which applies
    A once more; the reference takes it after, ksp.py:401-420): an update
    made to take 0.3 s does not show in the event."""
    import time
    from petsc_tpu_torch import config
    A_sp = stencil7((3, 6, 6))
    ksp, A = make_ksp(ptt, A_sp, ["-ksp_type", "cg", "-pc_type", "jacobi"], "cpu")
    guess = ksp.setGuessType("fischer", 2)
    real_update = guess.update
    monkeypatch.setattr(guess, "update", lambda x, b: (time.sleep(0.3), real_update(x, b)))
    config.log().reset()
    run(ptt, ksp, A, A_sp @ np.ones(A_sp.shape[0]))
    ev = config.log().get_event("KSPSolve")
    assert ev.count == 1 and ev.time < 0.3
    assert guess._n == 1


@pytest.mark.parametrize("how", ["option", "setMixedPrecision"])
def test_mixed_precision_matches_the_reference(how):
    """IR around GMRES(30) + ILU(0) on config 2's operator at 6 x 60 x 60
    (the case of chip_smoke.py's phase krylov at small size)."""
    A_sp = stencil7(chip_smoke.CONFIG2_SMALL)
    b = A_sp @ np.cos(0.01 * np.arange(A_sp.shape[0]))
    base = ["-ksp_rtol", "1e-8", "-ksp_max_it", "400"]
    args = base + (["-ksp_mixed_precision"] if how == "option" else [])
    res = {}
    for pkg, dev in ((pt_jax, None), (ptt, "cpu")):
        ksp, A = make_ksp(pkg, A_sp, args, dev)
        if how == "setMixedPrecision":
            ksp.setMixedPrecision()
        res[pkg] = run(pkg, ksp, A, b)
    (ij, rj, hj, xj), (ip, rp, hp, xp) = res[pt_jax], res[ptt]
    assert (ip, rp) == (ij, rj) == (18, "CONVERGED_RTOL")
    assert len(hp) == len(hj) == len(ksp._pass_its) + 1 == 3
    # the first pass: the reference's inner solve of b / ||b|| in f32
    inner, _ = krylov_contract._ir_parts("ref", A_sp, stencil_build.stencil7_coo(
        *chip_smoke.CONFIG2_SMALL))
    assert ksp._pass_its[0] == inner((b / np.linalg.norm(b)).astype(np.float32))[1]
    assert sum(ksp._pass_its) == ip
    np.testing.assert_allclose(hp[0], hj[0], rtol=1e-6)
    ratio = hp[1:] / hj[1:]
    assert np.all((ratio <= chip_smoke.KRYLOV_IR_FACTOR)
                  & (ratio >= 1 / chip_smoke.KRYLOV_IR_FACTOR)), ratio
    assert np.linalg.norm(b - A_sp @ xp) <= 1e-8 * np.linalg.norm(b)
    assert xp.dtype == np.float64


@pytest.mark.parametrize("ksp_type, option, value", [("bcgsl", "-ksp_bcgsl_ell", "4"),
                                                     ("idr", "-ksp_idr_s", "3"),
                                                     ("lgmres", "-ksp_lgmres_augment", "1")])
def test_type_options_reach_the_solver(ksp_type, option, value):
    A_sp = stencil7((3, 12, 12))
    b = A_sp @ np.cos(0.01 * np.arange(A_sp.shape[0]))
    args = ["-ksp_type", ksp_type, "-ksp_rtol", "1e-8", "-pc_type", "jacobi",
            "-ksp_gmres_restart", "5", option, value]
    res = {pkg: run(pkg, *make_ksp(pkg, A_sp, args, dev), b)
           for pkg, dev in ((pt_jax, None), (ptt, "cpu"))}
    (ij, rj, hj, _), (ip, rp, hp, _) = res[pt_jax], res[ptt]
    assert (ip, rp) == (ij, rj)
    np.testing.assert_allclose(hp, hj, rtol=1e-6, atol=0)
    plain = run(ptt, *make_ksp(ptt, A_sp, args[:-2], "cpu"), b)
    assert len(plain[2]) != len(hp) or not np.array_equal(plain[2], hp)
