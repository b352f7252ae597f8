"""The port's Jacobian and preconditioner lagging (-snes_lag_jacobian,
-snes_lag_preconditioner) and TSSetDM's sparse stage Jacobians against the
JAX package's, case for case with tests/test_snes_lag.py.

Tolerances (tests/nonlinear_parity.py): iterations and reasons equal,
histories to 1e-6 relative (entries below 1e-6 of the first to 1e-12 of
the first), final iterates to 1e-10 relative; the number of Jacobian
builds equal."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.nonlinear_parity import assert_snes_same, assert_vec, both, host, init, snes_record

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from examples import heat as heat_jax  # noqa: E402
from petsc_tpu_torch.examples import heat as heat_port  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    init()


def bratu_1d(B, n, lam=3.0):
    """The 1-D Bratu residual, written out of place in both packages."""
    h = 1.0 / (n - 1)

    def residual(u):
        lap = (2 * u[1:-1] - u[:-2] - u[2:]) / h ** 2
        return B.xp.concatenate([u[:1], lap - lam * B.xp.exp(u[1:-1]), u[-1:]])
    return residual


def run_lag(B, opts, n=64):
    for k, v in opts.items():
        B.pt.options().set_value(k, v)
    try:
        snes = B.pt.SNES().create()
        snes.setFunction(bratu_1d(B, n))
        snes.setTolerances(rtol=1e-10, max_it=50)
        x = B.pt.Vec.from_array(np.zeros(n))
        calls = {"n": 0}
        orig = snes._compute_jacobian_now

        def counted(xx):
            calls["n"] += 1
            return orig(xx)
        snes._compute_jacobian_now = counted
        snes.solve(None, x)
        out = snes_record(snes, x)
        out["builds"] = calls["n"]
        return out
    finally:
        for k in opts:
            B.pt.options().delete_value(k)


def lagged(opts):
    port, ref = both(run_lag, opts)
    assert port["reason"] > 0
    assert port["builds"] == ref["builds"]
    assert_snes_same(port, ref)
    return port


def test_lag_jacobian_freeze_still_converges():
    p0 = lagged({})
    assert p0["builds"] == p0["its"]            # rebuilt every iteration
    p2 = lagged({"snes_lag_jacobian": "-2"})
    assert p2["builds"] == 1                   # frozen after the first build
    assert p2["its"] >= p0["its"]              # the chord method: more steps
    assert_vec(p2["x"], p0["x"], rtol=1e-8)


def test_lag_every_other():
    p = lagged({"snes_lag_jacobian": "2"})
    assert p["builds"] < p["its"] or p["its"] <= 2


def test_lag_preconditioner_frozen():
    """A fresh Jacobian every step and a frozen P object."""
    p = lagged({"snes_lag_preconditioner": "-2"})
    assert p["builds"] == p["its"]


def run_ts_setdm(B, n=17, steps=20):
    heat = heat_jax if B.name == "jax" else heat_port
    da = B.pt.DMDA.create(2, (n, n), dof=1, stencil_width=1)
    hx = 1.0 / (n - 1)
    ts = B.pt.TS().create().setType("cn")
    ts.setDM(da)
    ts.setRHSFunction(heat.make_rhs(da))
    ts.setTimeStep(0.25 * hx * hx)
    ts.setMaxSteps(steps)
    ts.setMaxTime(1e9)
    assert ts.getSNES().dm is da
    xy = da.node_coords()
    u0 = np.sin(np.pi * xy[:, 0] * hx) * np.sin(np.pi * xy[:, 1] * hx)
    u = B.pt.Vec.from_array(u0)
    ts.solve(u)
    return {"u": host(u), "u0": u0, "t": ts.getTime(), "steps": ts.getStepNumber()}


def test_ts_setdm_sparse_stage_jacobians():
    """TSSetDM: the stage SNES takes the DM, so stage Jacobians are the
    coloured FD ones on the DMDA's stencil pattern."""
    port, ref = both(run_ts_setdm)
    assert port["steps"] == ref["steps"] == 20
    assert abs(port["t"] - ref["t"]) <= 1e-15
    uex = port["u0"] * np.exp(-2 * np.pi ** 2 * port["t"])
    assert np.abs(port["u"] - uex).max() < 2e-3
    assert_vec(port["u"], ref["u"])
