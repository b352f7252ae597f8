"""Jacobian-free Newton-Krylov as one loop on the device.

Counterpart of ``petsc_tpu/snes/compiled.py``. The reference compiles the
whole solve (Newton loop, matrix-free GMRES on exact ``jax.jvp`` actions,
backtracking) into one XLA program. Here it is a plain loop whose vectors
never leave the device: the Jacobian action is exact, linearised by
reverse mode once a Newton step (``ops/autodiff.py``: ``jax.jvp``'s
values at a fraction of ``torch.func.jvp``'s host cost), the Gram-Schmidt
products ``torch.mv`` and their updates the fused K3 (``axpy_normsq``),
the trial points K2 and their norms K4. Per Newton step
the host reads ||F|| once, the small Hessenberg matrix once, and each
trial's norm once. Needs a pure residual fn(x, *args).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import vecops as V
from ..ops.autodiff import Linearization


def _gmres_mf(jvp_fn, b, m):
    """Matrix-free GMRES(m), one cycle of fixed size: the least-squares
    solution over the Krylov space (enough for an inexact Newton step).
    The (m+1) x m least-squares problem is solved on the host by numpy's
    SVD-based lstsq, whose minimum-norm solution is the reference's when
    a happy breakdown leaves H rank-deficient."""
    n = b.numel()
    dt, dev = b.dtype, b.device
    nb = V.norm(b)
    nb_s = 1.0 if nb == 0 else nb
    Vb = torch.zeros((m + 1, n), dtype=dt, device=dev)
    Vb[0] = V.axpy(torch.zeros_like(b), 1.0 / nb_s, b)
    H = torch.zeros((m + 1, m), dtype=dt, device=dev)
    neg_one = torch.tensor(-1.0, dtype=dt, device=dev)
    for k in range(m):
        Vk = Vb[: k + 1]
        w = V.flat(jvp_fn(Vb[k]))
        h = torch.mv(Vk, w)
        w, _ = V.axpy_normsq(neg_one, torch.mv(Vk.t(), h), w)
        h2 = torch.mv(Vk, w)          # one refinement pass (CGS2)
        w, nsq = V.axpy_normsq(neg_one, torch.mv(Vk.t(), h2), w)
        nw = torch.sqrt(nsq)
        H[: k + 1, k] = h + h2
        H[k + 1, k] = nw
        Vb[k + 1] = w * torch.where(nw > 0, 1.0 / torch.where(nw == 0, 1.0, nw), 0.0)
    e1 = np.zeros(m + 1)
    e1[0] = nb
    y, *_ = np.linalg.lstsq(H.cpu().numpy().astype(np.float64), e1, rcond=None)
    return torch.mv(Vb[:m].t(), torch.as_tensor(y, dtype=dt, device=dev))


GMRES_M = 20      # the Krylov space of each inner solve


def jfnk_solve(fn, x0, args, rtol, atol, max_it=50, gmres_m=GMRES_M):
    """(x, its, fnorm, converged, trials) for fn(x, *args) = 0 from x0;
    trials[k] is the residuals the backtracking of Newton step k
    evaluated.

    The backtracking tries lambda = 1, 1/2, ..., 1/64 and keeps the first
    with ||F|| < (1 - 1e-4 lambda) ||F||_old, as the reference's scan
    does; it stops at that lambda instead of evaluating all seven (the
    iterate is the same, the residual count smaller). With none accepted
    it takes the step damped by 1/64."""
    def F(x):
        return V.flat(fn(x, *args))

    x = V.flat(x0).clone()
    f = F(x)
    fnorm = V.norm(f)
    ttol = max(rtol * fnorm, atol)
    done = fnorm <= ttol
    its = 0
    trials = []
    while not done and its < max_it:
        step = _gmres_mf(Linearization(F, x), f, gmres_m)
        accepted = False
        for i in range(7):
            lam = 0.5 ** i
            xn = V.axpy(x, -lam, step)
            fn_ = F(xn)
            nn = V.norm(fn_)
            if nn < (1.0 - 1e-4 * lam) * fnorm:
                accepted = True
                break
        trials.append(i + 1)
        if not accepted:
            xn = V.axpy(x, -1.0 / 64.0, step)
            fn_ = F(xn)
            nn = V.norm(fn_)
            trials[-1] += 1
        x, f, fnorm = xn, fn_, nn
        its += 1
        done = fnorm <= ttol
    return x, its, fnorm, done, trials
