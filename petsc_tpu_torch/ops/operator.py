"""Operator binding: reconstruct apply-functions from (meta, data).

Counterpart of ``petsc_tpu/ops/operator.py``. Every Mat/PC exposes
  meta   — a hashable descriptor (format kind, shapes, options)
  data   — a dict of device tensors
and `bind(meta, data)` returns an `Op` with functions on tensors (mult,
mult_t, diag, ...) — PETSc's symbolic/numeric split (symbolic ≈ meta,
numeric ≈ data) and its function-pointer vtable
(include/petsc/private/matimpl.h _MatOps) in one lookup per bind.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

_BINDERS: dict[str, Callable] = {}


def register_binder(kind: str, binder: Callable):
    _BINDERS[kind] = binder


@dataclass
class Op:
    """Bound operator: functions over device tensors."""
    mult: Callable                    # x -> A x
    mult_t: Callable | None = None    # x -> A^T x
    diag: Callable | None = None      # () -> diagonal of A
    meta: tuple | None = None
    mult_mat: Callable | None = None  # X (n, k) -> A X, where the kind has a block product

    def __call__(self, x):
        return self.mult(x)


def bind(meta: tuple, data) -> Op:
    kind = meta[0]
    if kind not in _BINDERS:
        raise KeyError(f"no operator binder registered for kind '{kind}'")
    op = _BINDERS[kind](meta, data)
    op.meta = meta
    return op


# Shell (matrix-free) operators: the callable is registered here and meta
# carries the handle, so (meta, data) stays the whole contract.
_SHELLS: dict[int, dict] = {}
_shell_counter = 0


def register_shell(fns: dict) -> int:
    global _shell_counter
    _shell_counter += 1
    _SHELLS[_shell_counter] = fns
    return _shell_counter


def _bind_shell(meta, data):
    _, handle = meta[0], meta[1]
    fns = _SHELLS[handle]
    ctx = data  # optional context threaded to the callable
    mult = fns["mult"]
    return Op(
        mult=(lambda x: mult(ctx, x)) if ctx is not None else mult,
        mult_t=fns.get("mult_t"),
        diag=fns.get("diag"),
    )


register_binder("shell", _bind_shell)
