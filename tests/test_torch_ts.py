"""The port's TS against the JAX package's, case for case with
tests/test_ts.py (euler, ssp, rk, beuler, cn, theta, bdf and rosw on the
decay problem, adaptive rk, arkimex, the fixed-step loop and its
derivative, compiled stage solves, the interpolated final time), plus the
ported heat right-hand side's jvp against a finite difference.

Tolerances (tests/nonlinear_parity.py): steps, times and reasons equal,
final states to 1e-10 relative."""

import math
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


def ts_record(ts, u):
    return {"steps": ts.getStepNumber(), "t": ts.getTime(),
            "reason": int(ts.getConvergedReason()), "u": host(u)}


def assert_ts_same(port, ref, rtol=1e-10):
    assert (port["steps"], port["reason"]) == (ref["steps"], ref["reason"])
    assert abs(port["t"] - ref["t"]) <= 1e-14 * max(1.0, abs(ref["t"]))
    assert_vec(port["u"], ref["u"], rtol=rtol)


def run_decay(B, ts_type, dt=0.01, T=1.0, adapt="none", u0=(1.0, 2.0), **setup):
    ts = B.pt.TS().create()
    ts.setType(ts_type)
    ts.setRHSFunction(lambda t, u: -u)
    ts.setTimeStep(dt)
    ts.setMaxTime(T)
    ts.adapt.kind = adapt
    for k, v in setup.items():
        getattr(ts, k)(v)
    u = B.pt.Vec.from_array(np.array(u0))
    ts.solve(u)
    return ts_record(ts, u)


@pytest.mark.parametrize("ts_type,tol", [
    ("euler", 5e-3), ("ssp", 1e-6), ("rk", 1e-7),
    ("beuler", 6e-3), ("cn", 1e-5), ("theta", 1e-5),
    ("bdf", 1e-3), ("rosw", 1e-6),
])
def test_decay(ts_type, tol):
    port, ref = both(run_decay, ts_type)
    assert port["reason"] > 0 and abs(port["t"] - 1.0) < 1e-12
    assert np.allclose(port["u"], np.array([1.0, 2.0]) * np.exp(-1.0), atol=tol)
    assert_ts_same(port, ref)


def test_rk_adaptive():
    port, ref = both(run_decay, "rk", dt=0.5, adapt="basic", setRKType="5dp")
    assert port["reason"] > 0 and port["steps"] < 30
    assert np.allclose(port["u"], np.array([1.0, 2.0]) * np.exp(-1.0), atol=1e-4)
    assert_ts_same(port, ref)


def run_stiffish(B):
    A = B.arr([[-2.0, 1.0], [1.0, -20.0]])
    ts = B.pt.TS().create()
    ts.setType("rk")
    ts.setRHSFunction(lambda t, u: A @ u)
    ts.setTimeStep(0.1)
    ts.setMaxTime(1.0)
    ts.adapt.kind = "basic"
    u = B.pt.Vec.from_array(np.array([1.0, 1.0]))
    ts.solve(u)
    return ts_record(ts, u)


def test_rk_3bs_adapt_stiffish():
    import scipy.linalg as sla
    port, ref = both(run_stiffish)
    exact = sla.expm(np.array([[-2.0, 1.0], [1.0, -20.0]])) @ np.array([1.0, 1.0])
    assert np.allclose(port["u"], exact, atol=1e-3)
    assert_ts_same(port, ref)


def run_arkimex(B):
    ts = B.pt.TS().create()
    ts.setType("arkimex")
    ts.setRHSFunction(lambda t, u: -1.0 * u)
    ts.setIFunction(lambda t, u, udot: udot + 50.0 * u)
    ts.setTimeStep(0.02)
    ts.setMaxTime(0.5)
    ts.adapt.kind = "none"
    u = B.pt.Vec.from_array(np.array([1.0]))
    ts.solve(u)
    return ts_record(ts, u)


def test_arkimex_split():
    port, ref = both(run_arkimex)
    assert port["reason"] > 0
    assert np.allclose(port["u"], np.exp(-51.0 * 0.5), rtol=2e-2)
    assert_ts_same(port, ref)


def run_beuler_stiff(B):
    ts = B.pt.TS().create()
    ts.setType("beuler")
    ts.setRHSFunction(lambda t, u: -1000.0 * u)
    ts.setTimeStep(0.1)
    ts.setMaxTime(1.0)
    ts.adapt.kind = "none"
    u = B.pt.Vec.from_array(np.array([1.0]))
    ts.solve(u)
    return ts_record(ts, u)


def test_beuler_stiff_stable():
    port, ref = both(run_beuler_stiff)
    assert port["reason"] > 0 and abs(port["u"][0]) < 1e-8
    assert_ts_same(port, ref)


def test_convergence_order_cn():
    errs = []
    for dt in (0.1, 0.05):
        port, ref = both(run_decay, "cn", dt=dt)
        assert_ts_same(port, ref)
        errs.append(abs(port["u"][0] - np.exp(-1.0)))
    rate = np.log2(errs[0] / errs[1])
    assert 1.7 < rate < 2.3, (errs, rate)


def run_compiled_vs_host(B):
    # the reference traces t; the port's loops pass it as a float
    sin = B.xp.sin if B is JAX else math.sin

    def rhs(t, u):
        return -u + 0.1 * sin(t)

    ts1 = B.pt.TS().create()
    ts1.setType("rk")
    ts1.setRHSFunction(rhs)
    ts1.setTimeStep(0.01)
    ts1.setMaxTime(1.0)
    ts1.adapt.kind = "none"
    u1 = B.pt.Vec.from_array(np.array([1.0, 2.0]))
    ts1.solve(u1)
    ts2 = B.pt.TS().create()
    ts2.setType("rk")
    ts2.setRHSFunction(rhs)
    ts2.setTimeStep(0.01)
    ts2.setMaxTime(1.0)
    u2 = B.pt.Vec.from_array(np.array([1.0, 2.0]))
    ts2.solveCompiled(u2)
    return {"host": host(u1), "loop": host(u2), "t": ts2.getTime()}


def test_solve_compiled_matches_host_loop():
    """The fixed-step loop equals the host-driven loop for rk."""
    port, ref = both(run_compiled_vs_host)
    assert abs(port["t"] - 1.0) < 1e-9
    assert np.allclose(port["host"], port["loop"], atol=1e-12)
    assert_vec(port["loop"], ref["loop"])
    assert_vec(port["host"], ref["host"])


def test_solve_compiled_differentiable():
    """d u_T / d u_0 = (1 - dt)^100 through the port's fixed-step loop
    (torch.func.grad), as through the reference's (jax.grad)."""
    ts = TORCH.pt.TS().create()
    ts.setType("euler")
    ts.setRHSFunction(lambda t, u: -u)
    ts.setTimeStep(0.01)
    ts.setMaxTime(1.0)

    def final(u0):
        uf, _ = ts.solveCompiled(u0, nsteps=100, dt=0.01)
        return uf[0]

    g = torch.func.grad(final)(torch.tensor([2.0], dtype=torch.float64))
    assert abs(float(g[0]) - (1 - 0.01) ** 100) < 1e-10


def run_compiled_stages(B, compiled):
    ts = B.pt.TS().create()
    ts.setType("beuler")
    ts.setRHSFunction(lambda t, u: -u ** 3 - u + 1.0)
    ts.setTimeStep(0.05)
    ts.setMaxTime(0.5)
    ts.adapt.kind = "none"
    ts.use_compiled_snes = compiled
    u = B.pt.Vec.from_array(np.array([0.0, 2.0]))
    ts.solve(u)
    return ts_record(ts, u)


@pytest.mark.parametrize("compiled", [False, True])
def test_compiled_stage_solves(compiled):
    """Implicit steps with the device-loop JFNK stage solves match the
    host-driven SNES path, in both packages."""
    port, ref = both(run_compiled_stages, compiled)
    assert port["reason"] > 0
    assert_ts_same(port, ref)
    other = run_compiled_stages(TORCH, not compiled)
    assert np.allclose(port["u"], other["u"], atol=1e-8)


def test_exact_final_interpolate():
    port, ref = both(run_decay, "rk", dt=0.03, u0=(1.0,), setExactFinalTime="interpolate")
    assert abs(port["t"] - 1.0) < 1e-12
    assert abs(port["u"][0] - np.exp(-1.0)) < 1e-4
    assert_ts_same(port, ref)


def test_heat_rhs_jvp_matches_fd():
    """The ported heat right-hand side (written out of place) carries its
    tangent: torch.func.jvp against a central difference in f64, and its
    value equals the reference's."""
    n = 17
    rhs = heat_port.make_rhs(TORCH.pt.DMDA.create(2, (n, n)))
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.random(n * n))
    v = torch.as_tensor(rng.standard_normal(n * n))
    jv = torch.func.jvp(lambda z: rhs(0.0, z), (u,), (v,))[1]
    h = 1e-5
    fd = (rhs(0.0, u + h * v) - rhs(0.0, u - h * v)) / (2 * h)
    assert torch.linalg.norm(jv - fd) <= 1e-7 * torch.linalg.norm(jv)
    ref = np.asarray(heat_jax.make_rhs(JAX.pt.DMDA.create(2, (n, n)))(0.0, JAX.arr(host(u))))
    np.testing.assert_allclose(host(rhs(0.0, u)), ref, rtol=1e-13, atol=1e-9)


def test_every_ts_type_registered():
    """The port's TS registry is the reference's (20 names)."""
    assert sorted(TORCH.pt.TS._impls) == sorted(JAX.pt.TS._impls)
    assert len(TORCH.pt.TS._impls) == 20
