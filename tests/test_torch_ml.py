"""petsc_tpu_torch's ml layer (PetscRegressor, the LETKF) against
petsc_tpu, on the CPU, after tests/test_ml.py.

Tolerances: coefficients, intercepts and predictions to 1e-10 relative
(OLS: both packages solve by thin SVD, in other libraries; ridge and lasso
the same arithmetic in other orders); on the ill-conditioned OLS designs
the residual norm to 1e-12 relative, evaluated in np.longdouble (in f64 the
product with columns of 1e6 rounds the residual at about 1e-11 by itself),
and the coefficients to 1e-7 relative (the scaled design's condition
number, 9.9e5, times eps is 2.2e-10; the near-collinear pair's part of the
solution moves by 1e-8 in either SVD); the LETKF's analysis ensemble
to 1e-10 relative (batched products and eigendecompositions against the
reference's vmapped ones)."""

import numpy as np
import pytest
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.ml import Regressor as RRegressor, gaspari_cohn as rgc, letkf_analysis as rletkf
from petsc_tpu_torch.ml import Regressor, gaspari_cohn, letkf_analysis

torch.set_num_threads(1)


def _init(args=()):
    pt_jax.init(args=list(args))
    ptt.init(args=list(args), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _data(n=200, p=5, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    w = rng.standard_normal(p)
    return X, X @ w + 2.0 + noise * rng.standard_normal(n), w


@pytest.mark.parametrize("lt,weight,noise,intercept", [
    ("ols", None, 0.0, True), ("ols", None, 0.1, True), ("ols", None, 0.1, False),
    ("ridge", 50.0, 0.1, True), ("lasso", 1.0, 0.0, True), ("lasso", 30.0, 0.1, False)])
def test_regressor_equals_the_reference(lt, weight, noise, intercept):
    _init()
    X, y, w = _data(n=300, p=8, noise=noise)
    fits = []
    for R in (RRegressor, Regressor):
        r = R().create().setLinearType(lt)
        r.setFitIntercept(intercept)
        if weight is not None:
            r.setRegularizerWeight(weight)
        r.fit(X, y)
        fits.append((np.asarray(r.getCoefficients().getArray())[:8], r.getIntercept(),
                     np.asarray(r.predict(X).getArray())[:300]))
    (cr, ir, pr), (cp, ip, pp) = fits
    assert _rel(cp, cr) <= 1e-10 and abs(ip - ir) <= 1e-10 * max(abs(ir), 1.0)
    assert _rel(pp, pr) <= 1e-10
    if lt == "ols" and noise == 0.0:
        assert np.allclose(cp, w, atol=1e-8) and abs(ip - 2.0) < 1e-8


def _ill_conditioned(kind):
    """A 200 x 10 standard normal design (seed 5) with y = X b + 0.1 noise:
    its columns scaled by logspace(0, 6, 10) (condition 9.9e5 after
    centring), or two columns nearly collinear (x9 = x8 + 1e-7 noise), or
    rank-deficient (x9 = x1 + x2 exactly, x5 = 0)."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((200, 10))
    if kind == "scaled":
        X = X * np.logspace(0, 6, 10)
    elif kind == "collinear":
        X[:, 9] = X[:, 8] + 1e-7 * rng.standard_normal(200)
    else:
        X[:, 9] = X[:, 1] + X[:, 2]
        X[:, 5] = 0.0
    beta = rng.standard_normal(10)
    return X, X @ beta + 0.1 * rng.standard_normal(200)


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("kind", ["scaled", "collinear", "rank_deficient"])
def test_ols_on_ill_conditioned_designs_equals_the_reference(kind, intercept):
    """OLS by the reference's thin-SVD least squares (no LSQR steps that
    stop short): the residual norm (in extended precision) to 1e-12 and
    the coefficients to 1e-7 relative of the reference's; a rank-deficient
    design gives the minimum-norm solution (numpy's pinv)."""
    _init()
    X, y = _ill_conditioned(kind)
    fits = []
    for R in (RRegressor, Regressor):
        r = R().create().setLinearType("ols")
        r.setFitIntercept(intercept)
        r.fit(X, y)
        coef = np.asarray(r.getCoefficients().getArray())[:10]
        e = (X.astype(np.longdouble) @ coef.astype(np.longdouble)
             + np.longdouble(r.getIntercept()) - y.astype(np.longdouble))
        resid = float(np.sqrt(np.sum(e * e)))
        fits.append((coef, r.getIntercept(), resid))
    (cr, ir, rr), (cp, ip, rp) = fits
    assert abs(rp - rr) <= 1e-12 * rr
    assert _rel(cp, cr) <= 1e-7 and abs(ip - ir) <= 1e-7 * max(abs(ir), 1.0)
    if kind == "rank_deficient":
        Xc, yc = (X - X.mean(0), y - y.mean()) if intercept else (X, y)
        assert _rel(cp, np.linalg.pinv(Xc) @ yc) <= 1e-10 and abs(cp[5]) <= 1e-12


def test_regressor_options_and_predict_into_a_vec():
    _init(["-regressor_linear_type", "ridge", "-regressor_regularizer_weight", "5"])
    X, y, _ = _data()
    r = Regressor().create().setFromOptions()
    assert (r.linear_type, r.regularizer_weight) == ("ridge", 5.0)
    r.fit(X, ptt.Vec.from_array(y))
    out = ptt.Vec.from_array(np.zeros(200))
    assert r.predict(X, out) is out
    with pytest.raises(KeyError):
        r.setType("kernel")
    with pytest.raises(ptt.Error):
        Regressor().create().setLinearType("huber").fit(X, y)


def _letkf_case(n, k, m, seed, loc_radius=None):
    rng = np.random.default_rng(seed)
    truth = np.sin(np.linspace(0, 2 * np.pi, n))
    Xf = truth[:, None] + 0.5 * rng.standard_normal((n, k))
    Hidx = np.linspace(0, n - 1, m).astype(int)
    H = np.zeros((m, n))
    H[np.arange(m), Hidx] = 1.0
    R = np.full(m, 0.01)
    yo = truth[Hidx] + 0.1 * rng.standard_normal(m)
    loc = None
    if loc_radius:
        d = np.abs(np.arange(n)[:, None] - Hidx[None, :])
        loc = rgc(d / loc_radius)
    return Xf, yo, H, R, loc, Hidx, truth


@pytest.mark.parametrize("n,k,m,radius,inflation", [(40, 20, 10, None, 1.0),
                                                     (30, 12, 6, 4.0, 1.0),
                                                     (96, 16, 24, 6.0, 1.1)])
def test_letkf_equals_the_reference(n, k, m, radius, inflation):
    _init()
    Xf, yo, H, R, loc, Hidx, _ = _letkf_case(n, k, m, 1, radius)
    a = np.asarray(rletkf(Xf, yo, H, R, inflation=inflation, localization=loc))
    b = letkf_analysis(Xf, yo, H, R, inflation=inflation, localization=loc)
    assert isinstance(b, torch.Tensor) and _rel(b.numpy(), a) <= 1e-10
    c = letkf_analysis(Xf, yo, lambda x: torch.as_tensor(H) @ x, R, inflation=inflation,
                       localization=loc)
    assert _rel(c.numpy(), a) <= 1e-10
    # the analysis spread shrinks at the observed points
    assert b.numpy()[Hidx].std(axis=1).mean() < Xf[Hidx].std(axis=1).mean()


def test_gaspari_cohn_is_the_references():
    r = np.linspace(-2.5, 2.5, 1001)
    assert np.array_equal(gaspari_cohn(r), rgc(r))
    assert gaspari_cohn(0.0) == 1.0 and gaspari_cohn(2.0) == 0.0
