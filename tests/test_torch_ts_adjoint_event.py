"""The port's trajectory, adjoint and forward sensitivities, and TSEvent,
against the JAX package's, case for case with
tests/test_ts_adjoint_event.py, plus a trajectory file written by the
reference read by the port, and the card phase's adjoint case (rk 3bs on
the heat grid) at 17^2.

Tolerances: steps, event times and reasons equal; final states and
lambda_0 to 1e-10 relative."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.nonlinear_parity import JAX, TORCH, assert_vec, both, host, init

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from examples import heat as heat_jax  # noqa: E402
from petsc_tpu_torch.examples import heat as heat_port  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    init()


def rk_ts(B, rhs, dt, T):
    ts = B.pt.TS().create()
    ts.setType("rk")
    ts.setRHSFunction(rhs)
    ts.setTimeStep(dt)
    ts.setMaxTime(T)
    ts.adapt.kind = "none"
    return ts


def run_adjoint_linear(B, a=1.3):
    ts = rk_ts(B, lambda t, u: -a * u, 0.01, 1.0)
    ts.setSaveTrajectory()
    u = B.pt.Vec.from_array(np.array([2.0]))
    ts.solve(u)
    lam = host(ts.adjointSolve(np.array([1.0]), np.array([2.0])))
    S = np.asarray(ts.forwardSensitivities(np.array([2.0]), np.array([1.0])))
    return {"lam": lam, "S": S, "u": host(u)}


def test_adjoint_linear_decay():
    port, ref = both(run_adjoint_linear)
    assert np.allclose(port["lam"], np.exp(-1.3), atol=1e-6)
    assert np.allclose(port["S"], np.exp(-1.3), atol=1e-6)
    assert_vec(port["lam"], ref["lam"])
    assert_vec(port["S"], ref["S"])
    assert_vec(port["u"], ref["u"])


def run_logistic(B, u0):
    ts = rk_ts(B, lambda t, u: u * (1.0 - u), 0.02, 1.0)
    ts.setSaveTrajectory()
    u = B.pt.Vec.from_array(np.array([u0]))
    ts.solve(u)
    return ts, float(host(u)[0])


def test_adjoint_nonlinear():
    lams = {}
    for B in (JAX, TORCH):
        ts, _ = run_logistic(B, 0.3)
        lams[B.name] = float(host(ts.adjointSolve(np.array([1.0]), np.array([0.3])))[0])
    eps = 1e-6
    fd = (run_logistic(TORCH, 0.3 + eps)[1] - run_logistic(TORCH, 0.3 - eps)[1]) / (2 * eps)
    assert abs(lams["torch"] - fd) < 1e-5
    assert abs(lams["torch"] - lams["jax"]) <= 1e-10 * abs(lams["jax"])


def run_event(B, post):
    g = 9.8

    def rhs(t, u):
        return B.xp.stack([u[1], 0.0 * u[1] - g])

    def bounce(ts_, t, u):
        u = np.array(host(u))
        u[1] = -0.5 * u[1]     # an inelastic bounce
        u[0] = 1e-9
        return u

    ts = rk_ts(B, rhs, 0.05, 3.0 if post else 10.0)
    ts.setEventHandler(lambda ts_, t, u: u[0], postevent=bounce if post else None,
                       terminate=not post)
    u = B.pt.Vec.from_array(np.array([5.0 if post else 10.0, 0.0]))
    ts.solve(u)
    return {"steps": ts.getStepNumber(), "t": ts.getTime(),
            "reason": int(ts.getConvergedReason()), "u": host(u)}


@pytest.mark.parametrize("post", [False, True], ids=["terminate", "postevent_bounce"])
def test_event(post):
    """The falling ball (z'' = -g): the event at z = 0 stops the solve, or
    a reflecting postevent continues it."""
    port, ref = both(run_event, post)
    assert (port["steps"], port["reason"]) == (ref["steps"], ref["reason"])
    assert abs(port["t"] - ref["t"]) <= 1e-12
    if post:
        assert port["reason"] > 0 and port["u"][0] > -1e-6
    else:
        assert port["reason"] == int(TORCH.pt.TSConvergedReason.CONVERGED_EVENT)
        assert abs(port["t"] - np.sqrt(2 * 10.0 / 9.8)) < 1e-4
        assert abs(port["u"][0]) < 1e-6
    assert_vec(port["u"], ref["u"], rtol=1e-9)


def run_traj(B, path):
    ts = rk_ts(B, lambda t, u: -u, 0.02, 0.5)
    ts.setSaveTrajectory()
    u = B.pt.Vec.from_array(np.array([1.0, 2.0]))
    ts.solve(u)
    ts.trajectorySave(path)
    return host(u)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_trajectory_singlefile_roundtrip(tmp_path, writer):
    """A trajectory file saved by either package (the reference's npz
    layout) reloads in a fresh port TS, whose replay gives the forward
    solution."""
    p = str(tmp_path / "traj.npz")
    uf = run_traj(TORCH if writer == "torch" else JAX, p)
    ts2 = rk_ts(TORCH, lambda t, u: -u, 0.02, 0.5)
    ts2.trajectoryLoad(p)
    ur = host(ts2.replay(torch.as_tensor(np.array([1.0, 2.0]))))
    assert np.allclose(ur, uf, atol=1e-12)


def run_heat_adjoint(B, n=17, steps=20):
    heat = heat_jax if B is JAX else heat_port
    da = B.pt.DMDA.create(2, (n, n))
    hx = 1.0 / (n - 1)
    ts = B.pt.TS().create()
    ts.setType("rk")
    ts.setRKType("3bs")
    ts.setRHSFunction(heat.make_rhs(da))
    ts.adapt.kind = "none"
    ts.setTimeStep(0.2 * hx * hx)
    ts.setMaxSteps(steps)
    ts.setMaxTime(1e9)
    ts.setSaveTrajectory()
    xy = da.node_coords()
    u0 = np.sin(np.pi * xy[:, 0] * hx) * np.sin(np.pi * xy[:, 1] * hx)
    u = B.pt.Vec.from_array(u0)
    ts.solve(u)
    uT = host(u)
    return {"u": uT, "lam": host(ts.adjointSolve(uT, u0))}


def test_heat_rk_adjoint():
    """chip_smoke.py's heat_rk_adjoint at 17^2: lambda_0 = (du_T/du_0)^T u_T."""
    port, ref = both(run_heat_adjoint)
    assert_vec(port["u"], ref["u"])
    assert_vec(port["lam"], ref["lam"])
