"""PF: pointwise-function objects (src/vec/pf: PFCreate/PFSetType/PFApply
with types constant, identity, quick (string) and shell).

Counterpart of ``petsc_tpu/sys/pf.py``: a PF is an elementwise torch map
applied to a Vec's tensor on its device. A ``string`` PF evaluates its
expression in x with ``torch`` under the names the reference evaluates it
with (``jnp``, ``np``), so "jnp.sin(x) + x*x" reads the same in both.
XLA contracts a product and a sum of the reference's jitted map into one
fused multiply-add where it can; torch rounds each operation alone, so the
two can differ in the last bit (ROADMAP section 3).
"""

from __future__ import annotations

import numpy as np
import torch


class PF:
    def __init__(self, dimin=1, dimout=1, comm=None):
        self.dimin, self.dimout = dimin, dimout
        self._fn = None

    @classmethod
    def create(cls, dimin=1, dimout=1, comm=None):
        return cls(dimin, dimout, comm)

    def setType(self, t, ctx=None):
        if t == "constant":
            c = 0.0 if ctx is None else ctx
            self._fn = lambda x: torch.full_like(x, c)
        elif t == "identity":
            self._fn = lambda x: x
        elif t == "string":
            # quick-function string of x, e.g. "x*x + 1"
            expr = compile(ctx, "<pf>", "eval")
            self._fn = lambda x: eval(expr, {"x": x, "torch": torch, "jnp": torch,
                                             "np": torch})
        else:
            raise KeyError(f"PF type '{t}'")
        return self

    def setApply(self, fn):
        """PFSetApplyRoutine (shell): fn maps a tensor to a tensor."""
        self._fn = fn
        return self

    def apply(self, x, y=None):
        """PFApplyVec: y = f(x) elementwise on x's device. With a Vec y the
        result stays on the device in y; a tensor x gives a tensor; else a
        host numpy array, as the reference returns."""
        if isinstance(x, torch.Tensor):
            t = x
        elif hasattr(x, "array"):
            t = x.array
        else:
            from .. import config
            t = torch.as_tensor(np.asarray(x)).to(config.device())
        out = self._fn(t)
        if y is not None:
            y.array = out.to(y.array.dtype)
            return y
        return out if isinstance(x, torch.Tensor) else out.cpu().numpy()

    __call__ = apply
