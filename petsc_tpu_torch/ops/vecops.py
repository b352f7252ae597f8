"""Vector steps of the nonlinear loops (SNES, TS, Tao) on the hand kernels.

The reference keeps the nonlinear iterate on the host as numpy; the port
keeps it where the Vec lives. Inner products and norms go through K4
(``dot2``), updates ``b + alpha c`` through K2 (``triad``); each scalar a
loop tests comes to the host as one read. On a CPU tensor each wrapper
takes its kernel's plain version, as every wrapper of the package does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from .pallas_kernels import axpy_normsq as _axpy_normsq, dot2, triad

def as_tensor(a, like=None):
    """`a` (numpy, list, scalar or tensor) as a contiguous 1-D tensor of the
    real dtype on the device of `like` (else the package's device)."""
    dev = like.device if like is not None else config.device()
    dt = like.dtype if like is not None else config.real_dtype()
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, dtype=np.float64))
    return t.to(device=dev, dtype=dt).reshape(-1).contiguous()


def flat(t):
    """A residual's value as a contiguous 1-D tensor."""
    return t.reshape(-1).contiguous()


def scalar(alpha, like):
    """alpha as the 0-d tensor K2 takes, on like's device."""
    return torch.tensor(float(alpha), dtype=like.dtype, device=like.device)


def dot(a, b):
    """<a, b> as a float (K4, one host read)."""
    return float(dot2(flat(a), flat(b))[0])


def normsq(a):
    a = flat(a)
    return float(dot2(a, a)[1])


def norm(a):
    """||a||_2 as a float (K4, one host read)."""
    v = normsq(a)
    return math.sqrt(v) if v >= 0 else float("nan")


def axpy(b, alpha, c):
    """b + alpha c as a new tensor (K2)."""
    b, c = flat(b), flat(c)
    return triad(b, c, scalar(alpha, b))


def axpy_normsq(alpha, x, y):
    """(y + alpha x, ||y + alpha x||^2 as a 0-d tensor) in one pass (K3);
    alpha a 0-d tensor on their device."""
    return _axpy_normsq(alpha, x, y)


def lincomb(terms, like):
    """sum_i alpha_i v_i over (alpha, v) pairs, one K2 launch a term."""
    out = torch.zeros_like(flat(like))
    for alpha, v in terms:
        if alpha != 0.0:
            out = axpy(out, alpha, v)
    return out


def finite(a):
    """All entries finite (one host read)."""
    return bool(torch.isfinite(a).all())
