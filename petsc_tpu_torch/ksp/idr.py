"""IDR(s): induced dimension reduction (van Gijzen & Sonneveld).

Counterpart of ``petsc_tpu/ksp/idr.py`` (TOMS Algorithm 913 idrs, with
biorthogonalized intermediate residuals): the fixed shadow space P is the
reference's, an orthonormalized block of numpy's default_rng(20260817)
normals; s from -ksp_idr_s (default 4). One outer iteration is s
products with A and PC applications, the s x s projections, and the omega
step; the history holds the initial and the final norm, as the
reference's. The projections with P, G and U are ``torch.mv`` products
with the stored blocks; the small triangular solves run on the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .common import KSPConfig, axpy, dot, initial_residual, norm, nz, scalar
from .impls_more import _Loop
from .impls_tr import small_solve


@lru_cache(maxsize=4)
def shadow_space(n, s, dtype, device):
    """The reference's P: (s, n), rows orthonormal; kept for the next solve
    of the same size and device (numpy's draw and QR of an n x s block are
    host work that the reference's jit does once, at its trace)."""
    rng = np.random.default_rng(20260817)
    P, _ = np.linalg.qr(rng.standard_normal((n, s)))
    return torch.as_tensor(P.T.copy(), dtype=dtype, device=device)


def solve_idr(A, B, b, x0, rtol, abstol, divtol, cfg: KSPConfig):
    s = 4
    for k, v in cfg.extra:
        if k == "s":
            s = int(v)
    x = x0
    n = b.numel()
    dt = b.dtype
    r = initial_residual(A, b, x0, cfg)
    lp = _Loop(cfg, b, float(norm(r)), rtol, abstol, divtol)
    P = shadow_space(n, s, dt, b.device)
    G = torch.zeros((s, n), dtype=dt, device=b.device)
    U = torch.zeros((s, n), dtype=dt, device=b.device)
    M = torch.eye(s, dtype=dt, device=b.device)
    om = torch.ones((), dtype=dt, device=b.device)
    neg_one = scalar(-1.0, b)
    while lp.live():
        f = torch.mv(P, r)
        for k in range(s):
            c = small_solve(M[k:, k:], f[k:])
            v = B.mult(axpy(r, neg_one, torch.mv(G[k:].t(), c)))
            uk = axpy(torch.mv(U[k:].t(), c), om, v)
            gk = A.mult(uk)
            for i in range(k):
                alpha = dot(P[i], gk) / nz(M[i, i])
                gk = axpy(gk, -alpha, G[i])
                uk = axpy(uk, -alpha, U[i])
            G[k], U[k] = gk, uk
            mk = torch.mv(P[k:], gk)
            M[k:, k] = mk
            beta = f[k] / nz(M[k, k])
            r = axpy(r, -beta, gk)
            x = axpy(x, beta, uk)
            if k + 1 < s:
                f = torch.cat([f[:k + 1], f[k + 1:] - beta * mk[1:]])
        v = B.mult(r)
        t = A.mult(v)
        om = dot(t, r) / nz(dot(t, t))
        x = axpy(x, om, v)
        r = axpy(r, -om, t)
        lp.step(float(norm(r)), record=False)
    lp.hist[min(lp.its, cfg.max_it)] = lp.rnorm
    return lp.result(x)
