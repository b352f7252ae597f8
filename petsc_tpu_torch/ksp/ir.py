"""Mixed-precision iterative refinement: an f64 outer loop around an f32
inner Krylov solve of the same type.

Counterpart of ``petsc_tpu/ksp/ir.py`` (KSP.setMixedPrecision,
-ksp_mixed_precision): the operator and the PC are bound again on float32
copies of their device data (:func:`to_f32`, as the reference's
``_to_f32`` of ``ksp.py:288-312``), so the existing kernels run their f32
entries; the outer loop forms the true residual with the f64 operator and
accumulates x in f64. The inner solve runs at most min(max_it, 1000)
iterations to inner_rtol (default 1e-6) with -ksp_converged_maxits; the
outer one at most max_outer (30) passes, and stops as the reference's on
rtol, divergence, a NaN, or stagnation (CONVERGED_STEP_LENGTH: the norm
above 0.9 of the one two passes before). The iteration count is the sum
of the inner ones, each kept in the result's ``pass_its``; the history
holds the outer norms.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..sys.error import KSPConvergedReason as KR
from .common import KSPConfig, SolveResult, axpy, empty_history, norm, scalar


def to_f32(tree):
    """A copy of device data with every float64 tensor cast to float32 (in
    dicts, tuples, lists and dataclasses such as T1's sweeps); callables
    kept in the data (cached products) are left out."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32) if tree.dtype == torch.float64 else tree
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items() if not callable(v)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_f32(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: to_f32(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)
                                            if isinstance(getattr(tree, f.name),
                                                          torch.Tensor)})
    return tree


def solve_ir(inner_fn, inner_cfg, A64, A32, B32, b, x0, rtol, abstol, divtol,
             cfg: KSPConfig):
    """cfg.extra = (max_outer, inner_rtol)."""
    max_outer = int(cfg.extra[0]) if cfg.extra else 30
    inner_rtol = cfg.extra[1] if len(cfg.extra) > 1 else 1e-6
    neg_one = scalar(-1.0, b)
    x = x0
    r = axpy(b, neg_one, A64.mult(x)) if cfg.guess_nonzero else b
    dp0 = float(norm(r))
    hist = empty_history(cfg, b.dtype)
    hist[0] = dp0
    ttol = max(rtol * dp0, abstol)
    dtol_bound = divtol * dp0
    rnorm, rnorm_prev, its, reason, pass_its = dp0, math.inf, 0, 0, []
    while reason == 0 and its < max_outer:
        scale = rnorm if rnorm != 0 else 1.0
        rs = (r / scale).to(torch.float32)
        res = inner_fn(A32, B32, rs, torch.zeros_like(rs), inner_rtol, 0.0, 1e30, inner_cfg)
        x = axpy(x, scalar(scale, b), res.x.to(b.dtype))
        r = axpy(b, neg_one, A64.mult(x))
        dp = float(norm(r))
        its += 1
        pass_its.append(int(res.its))
        hist[min(its, cfg.max_it)] = dp
        conv = 0
        if dp <= ttol:
            conv = int(KR.CONVERGED_ATOL if dp < abstol else KR.CONVERGED_RTOL)
        if dp > dtol_bound:
            conv = int(KR.DIVERGED_DTOL)
        if math.isnan(dp) or math.isinf(dp):
            conv = int(KR.DIVERGED_NANORINF)
        if conv == 0 and dp > 0.9 * rnorm_prev and its > 1:
            conv = int(KR.CONVERGED_STEP_LENGTH)
        reason = conv
        rnorm_prev, rnorm = rnorm, dp
    return SolveResult(x, sum(pass_its), rnorm, reason or int(KR.DIVERGED_ITS), hist, dp0,
                       pass_its=tuple(pass_its))
