"""PetscRegressor: regression solvers on the framework's linear algebra.

Counterpart of ``petsc_tpu/ml/regressor.py`` (reference src/ml/regressor:
PetscRegressorCreate/Fit/Predict, impls/linear: OLS by KSPLSQR on the
design matrix, ridge by the shifted normal equations, lasso by TaoBRGN with
an L1 regularizer). The design matrix is centred on the device; OLS runs
the port's KSP lsqr on it as a MatDense (as many steps as columns, where
LSQR reaches the least-squares solution in exact arithmetic), ridge solves
the normal equations with ``torch.linalg.solve``, and lasso takes the
reference's 500 ISTA proximal-gradient steps on the device.
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
        self.lsqr_its = None        # OLS: the LSQR steps taken

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
            coef = self._lsqr(Xc, yc)
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

    def _lsqr(self, Xc, yc):
        """min ||Xc w - yc|| by the port's KSP lsqr on a MatDense."""
        from ..ksp.ksp import KSP
        from ..mat.mat import MatDense
        m, n = Xc.shape
        D = MatDense(self.comm)
        D.setSizes((m, n))
        D._a = Xc.contiguous()
        D._assembled = True
        ksp = KSP().create()
        ksp.setOperators(D)
        ksp.setType("lsqr")
        ksp.getPC().setType("none")
        ksp.setTolerances(rtol=0.0, atol=0.0, max_it=n)
        ksp.setInitialGuessNonzero(True)    # x0 = 0 of the column length (A is m x n)
        b = Vec.from_array(yc)
        x = D.createVecRight()
        ksp.solve(b, x)
        self.lsqr_its = ksp.getIterationNumber()
        return x.array.clone()

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


def _ista_lasso(X, y, lam, iters=500):
    """Proximal gradient (ISTA) for 0.5||Xw - y||^2 + lam ||w||_1, on the
    device with no host read in the loop."""
    L = float(torch.linalg.matrix_norm(X, ord=2)) ** 2
    w = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    for _ in range(iters):
        z = w - (X.T @ (X @ w - y)) / L
        w = torch.sign(z) * torch.clamp(torch.abs(z) - lam / L, min=0.0)
    return w
