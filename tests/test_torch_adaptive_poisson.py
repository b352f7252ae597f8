"""The port's copy of the adaptive Poisson loop
(petsc_tpu_torch/examples/adaptive_poisson.py) against the reference's
(examples/adaptive_poisson.py) on the CPU: tests/test_adaptive_poisson.py's
cases, each round's mesh, dof count, solution, L2 error, indicator and
marked cells the reference's.

Tolerances (tests/plex_parity.py): meshes and counts equal, solutions and
errors to 1e-8 relative, the indicator to 1e-8."""

import numpy as np
import pytest
import torch

import examples.adaptive_poisson as rap
from petsc_tpu_torch.examples import adaptive_poisson as tap
from tests.plex_parity import U_RTOL, assert_same_mesh, init

torch.set_num_threads(1)


def test_amr_beats_uniform_per_dof():
    """Seven estimate -> mark -> adaptLabel -> solve rounds: each round's
    mesh, dofs and L2 error the reference's; the error falls, the rate is
    near-optimal, and the last round beats three uniform refinements."""
    init()
    plex, pr = tap.lshape_mesh(4), rap.lshape_mesh(4)
    hist = []
    for it in range(7):
        assert_same_mesh(plex, pr)
        u, ndof, err, gu, vol = tap.solve_p1(plex)
        ur, ndof_r, err_r, gur, _ = rap.solve_p1(pr)
        assert ndof == ndof_r and abs(err - err_r) <= U_RTOL * err_r
        assert np.linalg.norm(u - ur) <= U_RTOL * np.linalg.norm(ur)
        hist.append((ndof, err))
        if it < 6:
            eta, eta_r = tap.estimate(plex, gu), rap.estimate(pr, gur)
            assert np.allclose(eta, eta_r, rtol=1e-8, atol=1e-14 * eta_r.max())
            marked = tap.doerfler_mark(eta, 0.5)
            assert np.array_equal(marked, rap.doerfler_mark(eta_r, 0.5))
            plex, pr = plex.adaptLabel(marked), pr.adaptLabel(marked)
    errs = [e for _, e in hist]
    assert all(e2 < e1 for e1, e2 in zip(errs, errs[1:]))
    (n1, e1), (n2, e2) = hist[0], hist[-1]
    assert np.log(e1 / e2) / np.log(np.sqrt(n2 / n1)) > 1.7, hist
    _, ndof_u, err_u, _, _ = tap.solve_p1(tap.lshape_mesh(4).refine().refine().refine())
    assert hist[-1][0] < ndof_u and hist[-1][1] < err_u


def test_estimator_targets_the_corner():
    init()
    plex = tap.lshape_mesh(4)
    u, ndof, err, gu, vol = tap.solve_p1(plex)
    eta = tap.estimate(plex, gu)
    worst = plex.coords[plex.cells].mean(axis=1)[np.argmax(eta)]
    assert np.linalg.norm(worst) < 0.3, worst


def test_adaptive_main_and_the_sharded_round():
    """main() of two rounds: the reference's JSON record; -adapt_nshards 2
    raises the port's Error naming item 12."""
    import petsc_tpu_torch as pt
    out = tap.main(["-rounds", "2"], device="cpu")
    ref = rap.main(["-rounds", "2"])
    for key in ("adaptive", "uniform"):
        assert [n for n, _ in out[key]] == [n for n, _ in ref[key]]
        assert np.allclose([e for _, e in out[key]], [e for _, e in ref[key]], rtol=U_RTOL)
    with pytest.raises(pt.Error, match="item 12"):
        tap.main(["-rounds", "1", "-adapt_nshards", "2"], device="cpu")
