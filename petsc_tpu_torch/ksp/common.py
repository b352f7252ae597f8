"""Shared machinery of the Krylov solve loops.

Counterpart of ``petsc_tpu/ksp/common.py``. Every KSP implementation is a
function
    fn(A: Op, B: Op, b, x0, rtol, abstol, divtol, cfg) -> SolveResult
whose loop is a Python loop that reads its convergence scalars from the
card once per iteration and carries the typed convergence reason
(reference src/ksp/ksp/interface/iterativ.c:1519 KSPConvergedDefault):
converged when rnorm <= ttol = max(rtol*rnorm0, abstol); diverged when
rnorm > divtol*rnorm0 or NaN/Inf; reaching max_it is DIVERGED_ITS.
Convergence is NOT tested at iteration 0, but the iteration-0 norm seeds
rnorm0 and the monitor history.

The history, the norms it records and the tolerances they are tested
against take the solve's dtype, as the reference's do (its history and
scalars live in the solve's dtype, ``petsc_tpu/ksp/common.py:87-88``):
each norm read back to the host is rounded to that dtype
(:func:`rounder`), and ttol, abstol and the divergence bound are formed
in it (:func:`tolerances`). In float64 this changes nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.pallas_kernels import dot2, triad
from ..sys.error import KSPConvergedReason as KR

PRECONDITIONED = "preconditioned"
UNPRECONDITIONED = "unpreconditioned"
NATURAL = "natural"
NONE = "none"


class SolveResult(NamedTuple):
    x: torch.Tensor
    its: int
    rnorm: float            # final residual norm (per norm type)
    reason: int             # KSPConvergedReason value
    history: np.ndarray     # (max_it+1,) residual norms, NaN where unset
    rnorm0: float
    r: torch.Tensor | None = None   # final recursive residual, when carried
    pass_its: tuple = ()            # iterative refinement: each inner solve's its


@dataclass(frozen=True)
class KSPConfig:
    """Solver configuration fixed for one solve."""
    max_it: int = 10000
    normtype: str = PRECONDITIONED
    guess_nonzero: bool = False
    converged_maxits: bool = False   # -ksp_converged_maxits
    extra: tuple = ()                # solver-specific parameters


def check_converged(dp, ttol, abstol, dtol_bound) -> int:
    """KSPConvergedDefault body for n >= 1 (iterativ.c:1585-1620)."""
    if math.isnan(dp) or math.isinf(dp):
        return int(KR.DIVERGED_NANORINF)
    if dp <= ttol:
        return int(KR.CONVERGED_ATOL) if dp < abstol else int(KR.CONVERGED_RTOL)
    if dp > dtol_bound:
        return int(KR.DIVERGED_DTOL)
    return 0


def finalize_reason(reason, its, cfg: KSPConfig) -> int:
    """After the loop: max-out handling."""
    if reason == 0 and its >= cfg.max_it:
        return int(KR.CONVERGED_ITS) if cfg.converged_maxits else int(KR.DIVERGED_ITS)
    return int(reason)


def initial_residual(A, b, x0, cfg: KSPConfig):
    """r0 = b - A x0 (on K2), skipping the matvec for a zero initial guess
    (then r0 is b itself)."""
    if cfg.guess_nonzero:
        return residual(A, b, x0)
    return b


def empty_history(cfg: KSPConfig, dtype=torch.float64):
    """(max_it + 1) NaNs in the solve's dtype."""
    return np.full((cfg.max_it + 1,), np.nan,
                   dtype=np.float32 if dtype == torch.float32 else np.float64)


def rounder(dtype):
    """Rounds a host float to the solve's dtype (a float32 norm formed on
    the host in float64, such as sqrt of a float32 square, is rounded
    once more to float32; for sqrt, products and quotients of float32
    values that equals the float32 operation)."""
    if dtype == torch.float32:
        return lambda v: float(np.float32(v))
    return float


def tolerances(dp0, rtol, abstol, divtol, rnd):
    """(ttol, abstol, dtol_bound) formed in the solve's dtype, as the
    reference forms max(rtol * rnorm0, abstol) and divtol * rnorm0 with
    its scalars cast to that dtype first."""
    atol = rnd(abstol)
    return max(rnd(rnd(rtol) * dp0), atol), atol, rnd(rnd(divtol) * dp0)


# ---------------------------------------------------------------------
# vector steps of the Krylov loops on the hand kernels (K2 triad, K4
# dot2); on CPU tensors each runs its plain version
# ---------------------------------------------------------------------

def dot(a, b):
    """<a, b> as a 0-d tensor: the first of K4's two sums."""
    return dot2(a, b)[0]


def norm(a):
    """||a|| as a 0-d tensor (K4's second sum, then its square root)."""
    return torch.sqrt(dot2(a, a)[1])


def axpy(y, alpha, x):
    """y + alpha x on K2 (alpha a 0-d tensor on the vectors' device)."""
    return triad(y, x, alpha)


def residual(A, b, x):
    """b - A x, the subtraction on K2."""
    return triad(b, A.mult(x), scalar(-1.0, b))


def nz(v):
    """v with 0 replaced by 1: the guarded divisor of the reference's
    jnp.where(v == 0, 1.0, v)."""
    return torch.where(v == 0, torch.ones_like(v), v)


def scalar(v, like):
    """The host number v as a 0-d tensor of like's dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def dp_of(normtype, r, z):
    """The norm that the norm type selects, as a 0-d tensor: ||z||
    (preconditioned), ||r|| (unpreconditioned), sqrt|<z, r>| (natural),
    else 0."""
    if normtype == PRECONDITIONED:
        return norm(z)
    if normtype == UNPRECONDITIONED:
        return norm(r)
    if normtype == NATURAL:
        return torch.sqrt(torch.abs(dot(z, r)))
    return torch.zeros((), dtype=r.dtype, device=r.device)


def host(*vals):
    """The 0-d tensors vals read to the host in one transfer, as floats."""
    return torch.stack([v.reshape(()) for v in vals]).tolist()
