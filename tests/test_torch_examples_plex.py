"""The port's copy of PETSc's SNES ex12 (petsc_tpu_torch/examples/ex12.py)
against the reference's (examples/ex12.py) on the CPU:
tests/test_examples_snes.py's two ex12 cases, with the Newton iterations,
reason, inner iterations, history, nodal error and solution the
reference's (tests/test_torch_adaptive_poisson.py holds the other
example of the slice).

Tolerances (tests/plex_parity.py): counts equal, histories to 1e-6
relative (entries below 1e-6 of the first to 1e-12 of the first),
solutions and errors to 1e-8 relative."""

import numpy as np
import pytest
import torch

import examples.ex12 as rex
from petsc_tpu_torch.examples import ex12 as tex
from tests.plex_parity import U_RTOL, assert_history, host, init

torch.set_num_threads(1)


def _ex12(order, faces, extra=()):
    args = ["-fe_order", str(order), "-faces", str(faces), *extra]
    err, snes = tex.main(list(args), device="cpu")
    err_r, snes_r = rex.main(list(args))
    return (err, snes), (err_r, snes_r)


@pytest.mark.parametrize("extra", [(), ("-ksp_type", "gmres", "-pc_type", "gamg")])
def test_ex12_fem_nonlinear_poisson(extra):
    """ex12 P2 on 8 x 8 faces (tests/test_examples_snes.py) at PETSc's
    defaults and with GMRES + GAMG (the card's 512 case): Newton in at most
    8 iterations, nodal error below 5e-4, and the reference's (its run
    through plex_contract.py, which records the inner iterations)
    iterations, reason, inner iterations, history, nodal error and
    solution."""
    import plex_contract
    init(["-fe_order", "2", "-faces", "8", *extra])
    prob = tex.Ex12(2, 8)                 # ex12.main's objects
    x = prob.solve()
    err, snes = prob.nodal_error(x), prob.snes
    assert snes.getIterationNumber() <= 8 and err < 5e-4
    ref = {}
    plex_contract.run_ex12({"order": 2, "faces": 8, "args": list(extra)}, ref)
    assert snes.getIterationNumber() == ref["its"]
    assert int(snes.getConvergedReason()) == ref["reason"]
    assert snes._ksp_its == ref["ksp_its"]
    assert (snes.getKSP().getType(), snes.getKSP().getPC().getType()) == \
        (ref["ksp_type"], ref["pc_type"])
    assert_history(snes.getConvergenceHistory(), ref["history"])
    assert abs(err - ref["max_err"]) <= U_RTOL * ref["max_err"]
    u = host(x)
    assert abs(np.linalg.norm(u) - ref["u"]["norm2"]) <= U_RTOL * ref["u"]["norm2"]
    assert np.allclose(u[ref["u"]["sample_idx"]], ref["u"]["sample"], rtol=0,
                       atol=U_RTOL * max(abs(v) for v in ref["u"]["sample"]))


def test_ex12_p3_more_accurate_than_p1():
    (e1, _), (e1r, _) = _ex12(1, 8)
    (e3, _), (e3r, _) = _ex12(3, 8)
    assert e3 < e1 / 50
    assert abs(e1 - e1r) <= U_RTOL * e1r and abs(e3 - e3r) <= U_RTOL * e3r


def test_ex12_object_solves_again_to_the_same_state():
    """Ex12 (the card phase's entry): a second solve from zero on the same
    objects, with the COO plan kept, gives the first one's state and
    counts."""
    init(["-fe_order", "2", "-faces", "6"])
    prob = tex.Ex12(2, 6)
    x1 = prob.solve()
    its1, hist1 = prob.snes.getIterationNumber(), prob.snes.getConvergenceHistory()
    plan = prob.J._coo_plan
    x2 = prob.solve()
    assert prob.J._coo_plan is plan
    assert prob.snes.getIterationNumber() == its1
    assert np.array_equal(np.asarray(prob.snes.getConvergenceHistory()), np.asarray(hist1))
    assert np.array_equal(host(x1), host(x2))
    assert prob.nodal_error(x2) < 5e-3
    assert set(prob.seconds) == {"mesh", "dof_layout", "residual", "jacobian", "coo"}


def test_forcing_is_the_reference_manufactured_source():
    import jax.numpy as jnp
    pts = np.random.default_rng(12).random((5, 2))
    got = [float(tex.forcing(torch.as_tensor(p))) for p in pts]
    want = [float(rex.forcing(jnp.asarray(p))) for p in pts]
    assert np.allclose(got, want, rtol=1e-14, atol=0)
