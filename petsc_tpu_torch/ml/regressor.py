"""PetscRegressor: regression solvers on the framework's linear algebra.

Counterpart of ``petsc_tpu/ml/regressor.py`` (reference src/ml/regressor:
PetscRegressorCreate/Fit/Predict, impls/linear: OLS by KSPLSQR on the
design matrix, ridge by the shifted normal equations, lasso by TaoBRGN with
an L1 regularizer). The design matrix is centred on the device; OLS is the
reference's least-squares solve by thin SVD (``jnp.linalg.lstsq``: singular
values below eps * max(m, n) * s_max count as zero, so a rank-deficient
design gets the minimum-norm solution), ridge solves the normal equations
with ``torch.linalg.solve``, and lasso takes the reference's 500 ISTA
proximal-gradient steps on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..sys.error import Error
from ..sys.object import PObject
from ..vec.vec import Vec


def _host(a):
    if hasattr(a, "getDenseArray"):
        return a.getDenseArray()
    if isinstance(a, Vec):
        return a.array
    return a


def _dev(a):
    a = _host(a)
    if isinstance(a, torch.Tensor):
        return a.to(device=config.device(), dtype=config.real_dtype())
    return torch.as_tensor(np.asarray(a), dtype=config.real_dtype()).to(config.device())


class Regressor(PObject):
    _class_name = "PetscRegressor"
    _impls = ("linear",)

    def __init__(self, comm=None, **kw):
        super().__init__(**kw)
        self.comm = comm
        self._type = "linear"
        self.linear_type = "ols"    # ols | ridge | lasso
        self.fit_intercept = True
        self.regularizer_weight = 1.0
        self._coef = None
        self._intercept = 0.0

    def create(self, comm=None):
        self.comm = comm or self.comm
        return self

    def setType(self, t):
        if t not in self._impls:
            raise KeyError(t)
        self._type = t
        return self

    def setLinearType(self, t):
        self.linear_type = t
        return self

    def setFitIntercept(self, flag):
        self.fit_intercept = bool(flag)
        return self

    def setRegularizerWeight(self, w):
        self.regularizer_weight = float(w)
        return self

    def setFromOptions(self):
        t = self.opt("get_string", "regressor_type", None)
        if t:
            self.setType(t)
        t = self.opt("get_string", "regressor_linear_type", None)
        if t:
            self.linear_type = t
        w = self.opt("get_real", "regressor_regularizer_weight", None)
        if w is not None:
            self.regularizer_weight = w
        return self

    # ---------------- fit/predict ----------------

    def fit(self, X, y):
        X, y = _dev(X), _dev(y)
        if self.fit_intercept:
            xm, ym = X.mean(dim=0), y.mean()
            Xc, yc = X - xm, y - ym
        else:
            xm = ym = None
            Xc, yc = X, y
        lt = self.linear_type
        if lt == "ols":
            coef = _lstsq(Xc, yc)
        elif lt == "ridge":
            lam = self.regularizer_weight
            G = Xc.T @ Xc + lam * torch.eye(Xc.shape[1], dtype=Xc.dtype, device=Xc.device)
            coef = torch.linalg.solve(G, Xc.T @ yc)
        elif lt == "lasso":
            coef = _ista_lasso(Xc, yc, self.regularizer_weight)
        else:
            raise Error(f"regressor linear type {lt}")
        self._coef = coef
        self._intercept = float(ym - torch.dot(xm, coef)) if self.fit_intercept else 0.0
        return self

    def predict(self, X, y=None):
        out = _dev(X) @ self._coef + self._intercept
        if y is not None:
            y.array = out
            return y
        return Vec.from_array(out, comm=self.comm)

    def getCoefficients(self):
        return Vec.from_array(self._coef, comm=self.comm)

    def getIntercept(self):
        return self._intercept


def _lstsq(A, b):
    """min ||A x - b|| by thin SVD, as jnp.linalg.lstsq with its default
    cutoff: singular values below eps * max(m, n) * s_max (or 0) are dropped,
    which gives the minimum-norm solution of a rank-deficient A."""
    m, n = A.shape
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = (s > 0) & (s >= torch.finfo(A.dtype).eps * max(m, n) * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.T @ (s_inv * (U.T @ b))


def _ista_lasso(X, y, lam, iters=500):
    """Proximal gradient (ISTA) for 0.5||Xw - y||^2 + lam ||w||_1, on the
    device with no host read in the loop."""
    L = float(torch.linalg.matrix_norm(X, ord=2)) ** 2
    w = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    for _ in range(iters):
        z = w - (X.T @ (X @ w - y)) / L
        w = torch.sign(z) * torch.clamp(torch.abs(z) - lam / L, min=0.0)
    return w
