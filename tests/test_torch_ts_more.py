"""The port's basicsymplectic, pseudo, alpha, alpha2, irk, radau5, glee,
eimex, mimex, mprk and ssp variants, the dsp and history adaptors and the
heat example against the JAX package's, case for case with
tests/test_ts_more.py.

Tolerances (tests/nonlinear_parity.py): steps, times and reasons equal,
final states to 1e-10 relative."""

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


def run(B, ts_type, rhs=None, dt=0.05, T=1.0, u0=(1.0,), attrs=None, setup=None,
        max_steps=None):
    ts = B.pt.TS().create()
    ts.setType(ts_type)
    for k, v in (attrs or {}).items():
        setattr(ts, k, v)
    if rhs is not None:
        ts.setRHSFunction(rhs(B))
    if setup is not None:
        setup(B, ts)
    ts.setTimeStep(dt)
    ts.setMaxTime(T)
    if max_steps is not None:
        ts.setMaxSteps(max_steps)
    ts.adapt.kind = "none"
    u = B.pt.Vec.from_array(np.array(u0))
    ts.solve(u)
    out = ts_record(ts, u)
    out["ts"] = ts
    return out


def decay(B):
    return lambda t, u: -u


def order_rate(ts_type, dts, **kw):
    errs = []
    for dt in dts:
        port, ref = both(run, ts_type, decay, dt=dt, **kw)
        assert_ts_same(port, ref)
        errs.append(abs(port["u"][0] - np.exp(-1.0)))
    return errs, np.log2(errs[0] / errs[1])


@pytest.mark.parametrize("order,drift", [(1, 2e-2), (2, 1e-3), (4, 1e-6)])
def test_symplectic_harmonic_energy(order, drift):
    def split(B, ts):
        ts.setHamiltonianSplit(lambda t, p: p, lambda t, q: -q)

    port, ref = both(run, "basicsymplectic", setup=split, T=20.0, u0=(1.0, 0.0),
                     attrs={"symplectic_order": order})
    q, p = port["u"]
    assert abs(0.5 * (q * q + p * p) - 0.5) < drift
    assert abs(q - np.cos(port["t"])) < 0.3
    assert_ts_same(port, ref)


def test_pseudo_steady_state():
    port, ref = both(run, "pseudo", lambda B: (lambda t, u: -(u ** 3 + u - 2.0)),
                     T=1e12, u0=(5.0, -3.0), max_steps=200, attrs={"pseudo_fatol": 1e-10})
    assert np.allclose(port["u"], 1.0, atol=1e-6) and port["steps"] < 100
    assert_ts_same(port, ref)


def test_alpha_decay_order2():
    errs, rate = order_rate("alpha", (0.1, 0.05))
    assert rate > 1.5, (errs, rate)


def test_irk_gauss_order4():
    errs, rate = order_rate("irk", (0.1, 0.05))
    assert rate > 3.5, (errs, rate)


def test_irk_stiff_stable():
    lam, dt = -500.0, 0.1
    port, ref = both(run, "irk", lambda B: (lambda t, u: lam * u), dt=dt)
    z = lam * dt
    R = (1 + z / 2 + z * z / 12) / (1 - z / 2 + z * z / 12)
    assert abs(port["u"][0] - R ** 10) < 1e-6
    assert_ts_same(port, ref)


def run_heat(B, argv):
    heat = heat_jax if B is JAX else heat_port
    ts, ratio, exact = heat.main(argv, **({"device": "cpu"} if B is TORCH else {}))
    return {"steps": ts.getStepNumber(), "t": ts.getTime(),
            "reason": int(ts.getConvergedReason()), "ratio": ratio, "exact": exact}


@pytest.mark.parametrize("argv", [
    ["-ts_type", "cn", "-ts_dt", "0.002", "-ts_max_time", "0.02", "-da_grid_x", "17",
     "-da_grid_y", "17"],
    ["-ts_type", "rk", "-ts_dt", "0.0002", "-ts_max_time", "0.01", "-da_grid_x", "17",
     "-da_grid_y", "17"],
    ["-ts_type", "beuler", "-ts_dt", "0.0005", "-ts_max_time", "0.01", "-da_grid_x", "17",
     "-da_grid_y", "17"],
], ids=["cn", "rk", "beuler"])
def test_heat_equation_dmda(argv):
    """2-D heat (17^2, the reference test's 33^2 cut for its dense stage
    Jacobians): the port's decay equals the reference's, and CN's is
    within the FD error of the analytic one."""
    port, ref = both(run_heat, argv)
    assert (port["steps"], port["reason"]) == (ref["steps"], ref["reason"])
    assert abs(port["ratio"] - ref["ratio"]) <= 1e-10 * abs(ref["ratio"])
    if argv[1] == "cn":
        assert abs(port["ratio"] - port["exact"]) / port["exact"] < 5e-3


@pytest.mark.parametrize("gt,tol", [
    ("23", 1e-3), ("24", 1e-3), ("exrk2a", 1e-3), ("rk32g1", 1e-5),
])
def test_glee_decay(gt, tol):
    port, ref = both(run, "glee", decay, u0=(1.0, 2.0), attrs={"glee_type": gt})
    assert port["reason"] > 0
    assert np.allclose(port["u"], np.array([1.0, 2.0]) * np.exp(-1.0), atol=tol)
    assert_ts_same(port, ref)


def test_glee_global_error_tracks_true_error():
    port, ref = both(run, "glee", decay, attrs={"glee_type": "23"})
    ests = []
    for r in (port, ref):
        ts = r["ts"]
        Y = ts._glee_prop[1] if ts._glee_prop is not None else ts._glee_Y
        ests.append(abs(float(host(Y[1])[0])))
    true = abs(port["u"][0] - np.exp(-1.0))
    assert ests[0] > 0 and 0.1 * true < ests[0] < 10 * true
    assert abs(ests[0] - ests[1]) <= 1e-10 * ests[1]


def test_eimex_explicit_order():
    errs, rate = order_rate("eimex", (0.1, 0.05), attrs={"eimex_max_rows": 3})
    assert rate > 2.5, (errs, rate)


def imex(lam_stiff, lam_soft):
    def setup(B, ts):
        ts.setRHSFunction(lambda t, u: lam_soft * u)
        ts.setIFunction(lambda t, u, udot: udot - lam_stiff * u)
    return setup


def test_eimex_imex_stiff():
    port, ref = both(run, "eimex", setup=imex(-50.0, -1.0), T=0.5,
                     attrs={"eimex_max_rows": 2})
    assert port["reason"] > 0
    assert abs(port["u"][0] - np.exp(-51.0 * 0.5)) < 5e-3
    assert_ts_same(port, ref)


def test_mimex_stiff():
    port, ref = both(run, "mimex", setup=imex(-40.0, -1.0), T=0.5)
    assert port["reason"] > 0
    assert abs(port["u"][0] - np.exp(-41.0 * 0.5)) < 5e-2
    assert_ts_same(port, ref)


def test_mprk_multirate_order2():
    def split(B, ts):
        ts.setRHSSplit("slow", lambda t, u: -0.1 * u)
        ts.setRHSSplit("fast", lambda t, u: -3.0 * u)

    errs = []
    for dt in (0.1, 0.05):
        port, ref = both(run, "mprk", setup=split, dt=dt, attrs={"mprk_ratio": 2})
        assert_ts_same(port, ref)
        errs.append(abs(port["u"][0] - np.exp(-3.1)))
    rate = np.log2(errs[0] / errs[1])
    assert 1.7 < rate < 2.4, (errs, rate)


def test_mprk_with_is_partition():
    def split(B, ts):
        A = B.arr(np.diag([-0.2, -8.0]))
        ts.setRHSSplit("slow", lambda t, u: A @ u, iset=[0])
        ts.setRHSSplit("fast", lambda t, u: A @ u, iset=[1])

    port, ref = both(run, "mprk", setup=split, u0=(1.0, 1.0), attrs={"mprk_ratio": 4})
    assert np.allclose(port["u"], np.exp([-0.2, -8.0]), atol=2e-3)
    assert_ts_same(port, ref)


def run_adapt(B, kind):
    ts = B.pt.TS().create()
    ts.setType("rk")
    ts.setRHSFunction(lambda t, u: -u)
    if kind == "dsp":
        ts.setTimeStep(0.2)
        ts.adapt.kind = "dsp"
        ts.adapt.rtol = ts.adapt.atol = 1e-6
    else:
        ts.setTimeStep(0.1)
        ts.adapt.setHistory([0.1, 0.2, 0.3, 0.4])
    ts.setMaxTime(1.0)
    u = B.pt.Vec.from_array(np.array([1.0]))
    ts.solve(u)
    return ts_record(ts, u)


def test_adapt_dsp_controller():
    port, ref = both(run_adapt, "dsp")
    assert port["reason"] > 0 and abs(port["u"][0] - np.exp(-1.0)) < 1e-5
    assert_ts_same(port, ref)


def test_adapt_history_replay():
    port, ref = both(run_adapt, "history")
    assert abs(port["t"] - 1.0) < 1e-12 and port["steps"] == 4
    assert_ts_same(port, ref)


def test_alpha2_oscillator():
    w = 2.0 * np.pi

    def setup(B, ts):
        ts.setI2Function(lambda t, u, v, a: a + w * w * u)

    errs = []
    for dt in (0.01, 0.005):       # to t = 0.5 (the reference test's 1.0, halved)
        port, ref = both(run, "alpha2", setup=setup, dt=dt, T=0.5,
                         attrs={"alpha_radius": 1.0, "alpha2_v0": np.zeros(1)})
        assert port["reason"] > 0
        assert_ts_same(port, ref)
        errs.append(abs(port["u"][0] - np.cos(w * 0.5)))
    rate = np.log2(errs[0] / errs[1])
    assert rate > 1.7 and errs[1] < 1e-5, (errs, rate)


@pytest.mark.parametrize("sspt,order", [("rks2", 2), ("rks3", 3), ("rk104", 4)])
def test_ssp_variants_order(sspt, order):
    errs, rate = order_rate("ssp", (0.1, 0.05), attrs={"ssp_type": sspt})
    assert rate > order - 0.5, (sspt, errs, rate)


def test_radau5_order_and_lstability():
    errs, rate = order_rate("radau5", (0.2, 0.1))
    assert rate > 4.0, (errs, rate)
    port, ref = both(run, "radau5", lambda B: (lambda t, u: -1e4 * u), dt=1.0)
    assert abs(port["u"][0]) < 1e-3
    assert_ts_same(port, ref)
