"""PetscFV role: finite-volume discretization — Riemann fluxes, slope
reconstruction with limiters, and a DMDA-structured RHS builder.

Behavioral reference: src/dm/dt/fv (PetscFVLeastSquares/Upwind,
PetscLimiter types minmod/vanleer/mc/superbee/none, PetscFVIntegrate
RHSFunction; plexfv Riemann callbacks with (uL, uR, n) -> flux).

Counterpart of ``petsc_tpu/dm/fv.py``: on structured grids the face loop
is shifted-array arithmetic (``torch.roll``) — reconstruction, limiting,
and the Riemann solve happen for EVERY face of the grid at once as
elementwise torch ops on the device; the resulting RHS is a pure torch
function ready for TS (method-of-lines).
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------
# limiters (PetscLimiter)
# ---------------------------------------------------------------------

def _ratio(a, b):
    tiny = b.new_tensor(1e-300)            # in b's dtype (a bare 1e-300 would be f32: 0)
    return a / torch.where(torch.abs(b) < tiny, torch.where(b < 0, -tiny, tiny), b)


def limiter(name):
    """phi(r) slope limiters (PetscLimiterType)."""
    if name == "none":
        return lambda r: torch.ones_like(r)
    if name == "zero":
        return lambda r: torch.zeros_like(r)
    if name == "minmod":
        return lambda r: torch.clip(r, 0.0, 1.0)
    if name == "vanleer":
        return lambda r: (r + torch.abs(r)) / (1.0 + torch.abs(r))
    if name == "mc":
        return lambda r: torch.clamp(torch.minimum(
            2.0 * r, torch.clamp(0.5 * (1 + r), max=2.0)), min=0.0)
    if name == "superbee":
        return lambda r: torch.clamp(torch.maximum(
            torch.clamp(2.0 * r, max=1.0), torch.clamp(r, max=2.0)), min=0.0)
    raise KeyError(f"limiter '{name}'")


# ---------------------------------------------------------------------
# Riemann solvers
# ---------------------------------------------------------------------

def riemann_upwind(flux, wavespeed):
    """Simple upwind for scalar conservation laws with flux f(u): pick the
    side by the Rankine-Hugoniot speed sign."""
    def rs(uL, uR):
        s = wavespeed(0.5 * (uL + uR))
        return torch.where(s >= 0, flux(uL), flux(uR))
    return rs


def riemann_rusanov(flux, wavespeed):
    """Rusanov / local Lax-Friedrichs: monotone for any convex flux."""
    def rs(uL, uR):
        a = torch.maximum(torch.abs(wavespeed(uL)), torch.abs(wavespeed(uR)))
        return 0.5 * (flux(uL) + flux(uR)) - 0.5 * a * (uR - uL)
    return rs


# ---------------------------------------------------------------------
# structured FV (the DMDA fast path)
# ---------------------------------------------------------------------

class FV:
    """First/second-order Godunov FV on a periodic 1-D/2-D DMDA grid.

    rhs = makeRHS(): a pure torch fn(t, u) -> du/dt suitable for TS.
    Second order uses MUSCL reconstruction with the configured limiter.
    """

    def __init__(self, da, flux, wavespeed, riemann="rusanov",
                 limiter_type="minmod", order=2):
        self.da = da
        self.h = 1.0 / da.sizes[0]
        self.rs = (riemann_rusanov if riemann == "rusanov"
                   else riemann_upwind)(flux, wavespeed)
        self.phi = limiter(limiter_type)
        self.order = order
        self.shape = tuple(da.sizes[::-1])

    def _face_states(self, u, axis):
        """MUSCL uL/uR at every face along `axis` (periodic roll)."""
        um = torch.roll(u, 1, dims=axis)      # u_{i-1}
        up = torch.roll(u, -1, dims=axis)     # u_{i+1}
        if self.order == 1:
            return u, up
        # slopes limited by the ratio of consecutive differences
        d_minus = u - um
        d_plus = up - u
        r = _ratio(d_minus, d_plus)
        slope = self.phi(r) * d_plus
        uL = u + 0.5 * slope                # left state of face i+1/2
        rp = _ratio(torch.roll(d_minus, -1, dims=axis),
                    torch.roll(d_plus, -1, dims=axis))
        slope_p = self.phi(rp) * torch.roll(d_plus, -1, dims=axis)
        uR = up - 0.5 * slope_p             # right state of face i+1/2
        return uL, uR

    def makeRHS(self):
        h = self.h
        shape = self.shape
        ndim = len(shape)

        def rhs(t, uflat):
            u = uflat[: int(np.prod(shape))].reshape(shape)
            dudt = torch.zeros_like(u)
            for ax in range(ndim):
                uL, uR = self._face_states(u, ax)
                F = self.rs(uL, uR)         # flux at face i+1/2
                dudt = dudt - (F - torch.roll(F, 1, dims=ax)) / h
            return dudt.reshape(-1)

        return rhs
