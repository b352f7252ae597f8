"""PCSOR: symmetric, forward and backward SOR on two unit sweeps.

Counterpart of the SOR part of ``petsc_tpu/pc/more_pc.py`` (sor.c): with
L' = w D^-1 L and U' = w D^-1 U the SSOR preconditioner
w (2 - w) (D + w U)^-1 D (D + w L)^-1 reduces to two unit triangular
solves, (D + w L)^-1 x = (I + L')^-1 (D^-1 x) and
(D + w U)^-1 (D y) = (I + U')^-1 y, each a level-scheduled sweep of
:mod:`petsc_tpu_torch.ops.trisolve` (kernel T1 on the card). The factors
keep the real dtype, as the reference's do. The rest of the reference's
module (asm, composite, ksp, fieldsplit) is ROADMAP item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import operator, trisolve
from .pc import PC


class _PCSOR:
    """SSOR by default; ``-pc_sor_forward`` / ``-pc_sor_backward`` take one
    sweep, ``-pc_sor_omega`` sets w."""

    def __init__(self, pc):
        self.pc = pc
        self.omega = 1.0
        self.sweep = "symmetric"   # symmetric | forward | backward

    def set_from_options(self):
        o = self.pc.opt
        w = o("get_real", "pc_sor_omega", None)
        if w:
            self.omega = w
        if o("get_bool", "pc_sor_forward", False):
            self.sweep = "forward"
        if o("get_bool", "pc_sor_backward", False):
            self.sweep = "backward"

    def setup(self):
        A = self.pc.pmat
        indptr, indices, vals = A.getValuesCSR()
        m = A.row_layout.N
        w = self.omega
        rows = np.repeat(np.arange(m), np.diff(indptr))
        d = np.zeros(m)
        np.add.at(d, rows[indices == rows], vals[indices == rows])
        d = np.where(d == 0, 1.0, d)
        lo = indices < rows
        up = indices > rows
        scale_rows = w / d
        rd, dev = config.real_dtype(), config.device()
        data = {
            "L": trisolve.make_sweep(_recount(rows[lo], m), indices[lo],
                                     vals[lo] * scale_rows[rows[lo]], lower=True, dtype=rd),
            "U": trisolve.make_sweep(_recount(rows[up], m), indices[up],
                                     vals[up] * scale_rows[rows[up]], lower=False, dtype=rd),
            "dinv": torch.as_tensor(1.0 / d, dtype=rd, device=dev),
            "winv": torch.as_tensor(w / d, dtype=rd, device=dev),
        }
        return ("pc_sor", m, data["L"].nlev, data["U"].nlev, A.row_layout.Npad, self.sweep,
                float(w * (2.0 - w))), data


def _recount(rows, m):
    cnt = np.zeros(m + 1, dtype=np.int64)
    np.add.at(cnt, rows + 1, 1)
    return np.cumsum(cnt)


def _bind_pc_sor(meta, data):
    sweep, sc = meta[5], meta[6]

    def mult(x):
        if sweep == "forward":
            return trisolve.unit_lower_solve(data["L"], data["winv"] * x)
        if sweep == "backward":
            return trisolve.unit_upper_solve(data["U"], data["winv"] * x)
        y = trisolve.unit_lower_solve(data["L"], data["dinv"] * x)
        return sc * trisolve.unit_upper_solve(data["U"], y)

    return operator.Op(mult=mult)


PC.register_impl("sor", _PCSOR)
operator.register_binder("pc_sor", _bind_pc_sor)
