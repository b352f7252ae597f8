"""Ensemble data assimilation: LETKF local analysis.

Counterpart of ``petsc_tpu/ml/letkf.py`` (reference src/ml/da, PetscDA
ensemble Kalman; impls/ensemble/letkf/kokkos/letkf_local_analysis.kokkos.cxx,
the per-point local analysis batched on the device). Every state point's
k x k analysis runs at once on the device: the tapered products
Yp^T diag(rho_i / R) Yp of all points as one product with the observations'
outer products, the k x k symmetric eigendecompositions as one batched
``torch.linalg.eigh`` (the library call the reference's ``jnp.linalg.eigh``
under ``vmap`` is), then batched products.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config


def _dev(a):
    if isinstance(a, torch.Tensor):
        return a.to(device=config.device(), dtype=config.real_dtype())
    return torch.as_tensor(np.asarray(a), dtype=config.real_dtype()).to(config.device())


def letkf_analysis(Xf, yo, H, R_diag, inflation=1.0, localization=None):
    """One LETKF analysis step.

    Xf: (n, k) forecast ensemble (state dim n, ensemble size k)
    yo: (m,) observations
    H:  (m, n) observation operator (dense, or a callable x -> Hx for one
      member)
    R_diag: (m,) observation error variances
    localization: optional (n, m) weights rho_ij in [0, 1] tapering each
      observation's influence on each state point (Gaspari-Cohn style);
      None = one global ETKF with the full observation set.

    Returns Xa: (n, k) analysis ensemble, a tensor on the device.
    """
    Xf, yo, R_diag = _dev(Xf), _dev(yo), _dev(R_diag)
    n, k = Xf.shape
    xbar = Xf.mean(dim=1, keepdim=True)
    Xp = Xf - xbar                        # perturbations (n, k)
    if callable(H):
        Yf = torch.stack([H(Xf[:, j]) for j in range(k)], dim=1)
    else:
        Yf = _dev(H) @ Xf                 # (m, k)
    ybar = Yf.mean(dim=1, keepdim=True)
    Yp = Yf - ybar                        # (m, k)
    d = yo - ybar[:, 0]                   # innovation (m,)
    rho = torch.ones((1, len(yo)), dtype=Xf.dtype, device=Xf.device) \
        if localization is None else _dev(localization)
    w_obs = rho / R_diag                  # tapered R^-1, one row a point
    # Yp^T diag(w) Yp for every row w at once: w @ (Yp_i Yp_j) over the obs
    outer = (Yp[:, :, None] * Yp[:, None, :]).reshape(len(yo), k * k)
    eye = torch.eye(k, dtype=Xf.dtype, device=Xf.device)
    Pa_inv = (k - 1) / inflation * eye + (w_obs @ outer).reshape(-1, k, k)
    evals, evecs = torch.linalg.eigh(Pa_inv)
    evals = torch.clamp(evals, min=1e-12)
    Pa = (evecs / evals[:, None, :]) @ evecs.transpose(1, 2)
    Wa = (evecs / torch.sqrt(evals)[:, None, :]) @ evecs.transpose(1, 2) * np.sqrt(k - 1.0)
    Cd = (w_obs * d) @ Yp                 # C d for every point, (rows, k)
    wbar = (Pa @ Cd[:, :, None])[:, :, 0]
    if localization is None:
        return xbar + Xp @ (wbar[0][:, None] + Wa[0])
    incr = (Xp * wbar).sum(dim=1)
    ens = (Xp[:, None, :] @ Wa)[:, 0, :]
    return xbar + incr[:, None] + ens


def gaspari_cohn(r):
    """Gaspari-Cohn 5th-order piecewise localization function of r =
    distance / localization_radius (support 2), in numpy as the
    reference's."""
    r = np.abs(np.asarray(r, dtype=np.float64))
    w = np.zeros_like(r)
    m1 = r <= 1.0
    m2 = (r > 1.0) & (r < 2.0)
    x = r[m1]
    w[m1] = (((-0.25 * x + 0.5) * x + 0.625) * x - 5.0 / 3.0) * x ** 2 + 1.0
    x = r[m2]
    w[m2] = ((((x / 12.0 - 0.5) * x + 0.625) * x + 5.0 / 3.0) * x
             - 5.0) * x + 4.0 - 2.0 / (3.0 * x)
    return np.clip(w, 0.0, 1.0)
