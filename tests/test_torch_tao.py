"""The port's Tao against the JAX package's, case for case with
tests/test_tao.py (the chained Rosenbrock of rosenbrock1.c under lmvm,
nls, ntr, cg, bnls, ntl; blmvm, bncg, bqnls and tron with bounds; brgn and
pounders least squares; Nelder-Mead; almm; owlqn; ssils and its aliases;
pdipm/ipm; bmrm; lcl), the L-BFGS two-loop recursion against the
reference's, and the card phase's Rosenbrock at n = 2^10.

Tolerances (tests/nonlinear_parity.py): iterations and reasons equal, the
objective and gradient-norm histories to 1e-6 relative (entries below
1e-6 of the first to 1e-12 of the first), final iterates to 1e-10
relative."""

import numpy as np
import pytest
import torch

from tests.nonlinear_parity import (JAX, TORCH, assert_history, assert_vec, both, host,
                                    init)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    init()


def rosenbrock(B):
    def f(x):
        return B.xp.sum(100.0 * (x[1::2] - x[0::2] ** 2) ** 2 + (1.0 - x[0::2]) ** 2)
    return f


def tao_record(tao, x):
    h = np.asarray(tao._history, dtype=np.float64).reshape(-1, 2)
    return {"its": tao.getIterationNumber(), "reason": int(tao.getConvergedReason()),
            "f": h[:, 0], "g": h[:, 1], "x": host(x)}


def assert_tao_same(port, ref, vec_rtol=1e-10, histories=True):
    assert (port["its"], port["reason"]) == (ref["its"], ref["reason"])
    if histories:
        assert_history(port["f"], ref["f"], "f history")
        assert_history(port["g"], ref["g"], "gradient-norm history")
    assert_vec(port["x"], ref["x"], rtol=vec_rtol)


def run(B, ttype, objective=None, x0=None, bounds=None, maxit=None, tol=None, setup=None):
    tao = B.pt.Tao().create()
    tao.setType(ttype)
    if objective is not None:
        tao.setObjective(objective(B))
    if bounds is not None:
        tao.setVariableBounds(*bounds)
    if maxit is not None:
        tao.setMaximumIterations(maxit)
    if tol is not None:
        tao.setTolerances(gatol=tol)
    if setup is not None:
        setup(B, tao)
    x = B.pt.Vec.from_array(np.asarray(x0, dtype=np.float64))
    tao.solve(x)
    return tao_record(tao, x)


@pytest.mark.parametrize("ttype,maxit", [
    ("lmvm", 200), ("nls", 100), ("ntr", 100), ("bnls", 100), ("ntl", 100),
])
def test_rosenbrock(ttype, maxit):
    port, ref = both(run, ttype, rosenbrock, np.zeros(10), maxit=maxit)
    assert port["reason"] > 0
    assert np.allclose(port["x"], 1.0, atol=1e-4)
    assert_tao_same(port, ref)


def test_rosenbrock_cg():
    """Known difference (ROADMAP section 3): nonlinear CG on the
    10-variable Rosenbrock amplifies rounding, so its iteration count
    follows the summation order of the inner products: the reference
    takes 38 iterations with np.dot and 33 with the same dots as
    sums of products (its module's np.dot swapped below), the port 41.
    Held: the reason and the solution as the reference test holds them,
    and the objective history to 1e-6 relative over the prefix where the
    reference's two runs agree to 1e-7."""
    import types

    import petsc_tpu.tao.tao as ref_tao
    port, ref = both(run, "cg", rosenbrock, np.zeros(10), maxit=800)
    shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    shim.dot = lambda a, b: np.sum(np.asarray(a) * np.asarray(b))
    ref_tao.np = shim
    try:
        ref2 = run(JAX, "cg", rosenbrock, np.zeros(10), maxit=800)
    finally:
        ref_tao.np = np
    assert port["reason"] == ref["reason"] == ref2["reason"] > 0
    assert np.allclose(port["x"], 1.0, atol=1e-4)
    m = min(len(ref["f"]), len(ref2["f"]), len(port["f"]))
    own = np.abs(ref["f"][:m] - ref2["f"][:m]) <= 1e-7 * np.abs(ref["f"][:m])
    k = int(np.argmin(own)) if not own.all() else m
    assert k >= 5
    assert_history(port["f"][:k], ref["f"][:k], "f history")


def test_rosenbrock_card_case_small():
    """chip_smoke.py's tao_lmvm and tao_nls at n = 2^10 (the card's 2^20)."""
    for ttype in ("lmvm", "nls"):
        port, ref = both(run, ttype, rosenbrock, np.zeros(2 ** 10))
        assert port["reason"] > 0
        assert_tao_same(port, ref)


def quad2(B):
    return lambda x: B.xp.sum((x - 2.0) ** 2)


@pytest.mark.parametrize("ttype,n,x0", [("blmvm", 5, 0.5), ("bncg", 6, 0.3), ("bqnls", 6, 0.3)])
def test_bounded_quadratic(ttype, n, x0):
    """The optimum (2, ...) clipped at the upper bound 1."""
    port, ref = both(run, ttype, quad2, np.full(n, x0), bounds=(np.zeros(n), np.ones(n)))
    assert port["reason"] > 0
    assert np.allclose(port["x"], 1.0, atol=1e-6)
    assert_tao_same(port, ref)


def test_tron_bounds():
    port, ref = both(run, "tron", rosenbrock, np.zeros(10),
                     bounds=(np.full(10, -0.5), np.full(10, 0.8)))
    sol = port["x"]
    assert port["reason"] > 0
    assert (sol >= -0.5 - 1e-10).all() and (sol <= 0.8 + 1e-10).all()
    assert np.isclose(sol[0::2].max(), 0.8, atol=1e-4)
    assert_tao_same(port, ref)


def exp_fit(B, tao):
    t = B.arr(np.linspace(0, 1, 20))
    y = 2.0 * B.xp.exp(1.5 * t)
    tao.setResidual(lambda p: p[0] * B.xp.exp(p[1] * t) - y)


def test_brgn_least_squares():
    port, ref = both(run, "brgn", x0=[1.0, 1.0], setup=exp_fit)
    assert port["reason"] > 0
    assert np.allclose(port["x"], [2.0, 1.5], atol=1e-6)
    assert_tao_same(port, ref)


def test_pounders_least_squares():
    port, ref = both(run, "pounders", x0=[1.0, 1.0], setup=exp_fit, maxit=200, tol=1e-10)
    assert port["reason"] > 0
    assert np.allclose(port["x"], [2.0, 1.5], atol=1e-4)
    assert_tao_same(port, ref)


@pytest.mark.parametrize("ttype", ["nm", "neldermead"])
def test_neldermead(ttype):
    port, ref = both(run, ttype, lambda B: (lambda x: B.xp.sum((x - 3.0) ** 2)),
                     np.zeros(3), tol=1e-8)
    assert np.allclose(port["x"], 3.0, atol=1e-3)
    assert port["its"] == ref["its"]
    assert_vec(port["x"], ref["x"])


def test_almm_equality_constrained():
    def setup(B, tao):
        tao.setEqualityConstraints(lambda x: B.xp.stack([x[0] + x[1] - 1.0]))

    port, ref = both(run, "almm", lambda B: (lambda x: B.xp.sum(x ** 2)), np.zeros(2),
                     setup=setup)
    assert np.allclose(port["x"], 0.5, atol=1e-4)
    assert port["its"] == ref["its"]
    assert_vec(port["x"], ref["x"])


def test_almm_inequality():
    def setup(B, tao):
        tao.setInequalityConstraints(lambda x: x - 1.0)

    port, ref = both(run, "almm", quad2, np.zeros(3), setup=setup)
    assert np.allclose(port["x"], 1.0, atol=1e-3)
    assert port["its"] == ref["its"]
    assert_vec(port["x"], ref["x"])


def test_owlqn_l1_sparsity():
    rng = np.random.default_rng(0)
    A = rng.random((40, 10))
    xs = np.zeros(10)
    xs[1], xs[7] = 2.0, -1.0
    b = A @ xs

    def setup(B, tao):
        Ab, bb = B.arr(A), B.arr(b)
        tao.setObjective(lambda x: 0.5 * B.xp.sum((Ab @ x - bb) ** 2))
        tao.setRegularizerWeight(0.5)

    port, ref = both(run, "owlqn", x0=np.zeros(10), setup=setup, tol=1e-6)
    sol = port["x"]
    assert np.sum(np.abs(sol) > 0.05) <= 4
    assert abs(sol[1]) > 0.5 and abs(sol[7]) > 0.2
    assert_tao_same(port, ref)


def test_lbfgs_two_loop_matches_reference():
    """The port's L-BFGS two-loop recursion (Tao lmvm's and SNES qn's)
    equals the reference's host _lbfgs_dir on the same pairs."""
    from petsc_tpu.tao.tao import _lbfgs_dir as ref_dir
    from petsc_tpu_torch.tao.tao import _lbfgs_dir as port_dir
    rng = np.random.default_rng(0)
    n = 36
    A = np.diag(np.linspace(1.0, 4.0, n)) + 0.1
    S = [rng.standard_normal(n) for _ in range(4)]
    Y = [A @ s for s in S]
    g = rng.standard_normal(n)
    ref = ref_dir(S, Y, g.copy())
    got = host(port_dir([torch.as_tensor(s) for s in S], [torch.as_tensor(y) for y in Y],
                        torch.as_tensor(g)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ttype", ["ssils", "ssfls", "asils", "asfls"])
def test_ssils_complementarity(ttype):
    """0 <= x _|_ Mx + q >= 0 with the solution (0.5, 0)."""
    def setup(B, tao):
        M, q = B.arr([[2.0, 0.5], [0.5, 1.0]]), B.arr([-1.0, 1.0])
        tao.setConstraints(lambda x: M @ x + q)

    port, ref = both(run, ttype, x0=[1.0, 1.0], setup=setup, tol=1e-10)
    assert port["reason"] > 0
    assert np.allclose(port["x"], [0.5, 0.0], atol=1e-7)
    assert_tao_same(port, ref)


@pytest.mark.parametrize("ttype", ["pdipm", "ipm"])
def test_pdipm_bound_constrained(ttype):
    port, ref = both(run, ttype, quad2, np.full(4, 0.5), bounds=(np.zeros(4), np.ones(4)),
                     maxit=100, tol=1e-8)
    assert port["reason"] > 0
    assert np.allclose(port["x"], 1.0, atol=1e-6)
    assert_tao_same(port, ref)


def test_pdipm_interior_optimum():
    def obj(B):
        return lambda x: B.xp.sum((x - 0.3) ** 2) + 0.1 * x[0] * x[1]

    port, ref = both(run, "pdipm", obj, np.full(2, 0.5), bounds=(np.zeros(2), np.ones(2)),
                     maxit=200, tol=1e-9)
    assert port["reason"] > 0
    refsol = np.linalg.solve(np.array([[2.0, 0.1], [0.1, 2.0]]), np.array([0.6, 0.6]))
    assert np.allclose(port["x"], refsol, atol=1e-5)
    assert_tao_same(port, ref)


def test_bmrm_regularized_risk():
    A = np.array([[1.0, 0.2], [0.1, 1.5], [0.7, 0.3]])
    y = np.array([1.0, -1.0, 0.5])

    def setup(B, tao):
        Ab, yb = B.arr(A), B.arr(y)
        tao.bmrm_lambda = 0.5
        tao.setObjective(lambda w: B.xp.sum(B.xp.logaddexp(
            B.arr(0.0) if B is JAX else torch.zeros((), dtype=torch.float64),
            -(Ab @ w) * yb)))

    port, ref = both(run, "bmrm", x0=np.zeros(2), setup=setup, maxit=200, tol=1e-5)
    assert port["reason"] > 0
    assert_tao_same(port, ref)


def test_lcl_pde_constrained():
    n, alpha = 4, 0.1
    A = np.diag([2.0, 2.1, 2.2, 2.3])
    t = np.array([1.0, 2.0, 3.0, 4.0])

    def setup(B, tao):
        Ab, tb = B.arr(A), B.arr(t)
        tao.n_design = n
        tao.setObjective(lambda z: 0.5 * B.xp.sum((z[n:] - tb) ** 2)
                         + 0.5 * alpha * B.xp.sum(z[:n] ** 2))
        tao.setConstraints(lambda z: Ab @ z[n:] - z[:n])

    port, ref = both(run, "lcl", x0=np.zeros(2 * n), setup=setup, maxit=300, tol=1e-10)
    assert port["reason"] > 0
    uex = np.linalg.solve(np.eye(n) + alpha * A @ A, t)
    assert np.allclose(port["x"][n:], uex, atol=1e-6)
    assert np.allclose(port["x"][:n], A @ uex, atol=1e-6)
    assert_tao_same(port, ref)


def test_every_tao_type_registered():
    """The port's Tao registry is the reference's (24 names)."""
    assert sorted(TORCH.pt.Tao._impls) == sorted(JAX.pt.Tao._impls)
    assert len(TORCH.pt.Tao._impls) == 24
