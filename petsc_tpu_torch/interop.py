"""Carry the reference package's state into the port.

The JAX package's operators are ``(meta, data)`` pairs of a plain tuple
and a dict of arrays, and its MatAIJ gives its host CSR through
``getValuesCSR()``; given as numpy arrays, they become the port's objects
on the device of ``config.init``, and so does a trisolve plan of its
``ops/trisolve.py``. The parity tests use this so that both packages
compute on the same operator, factors and vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .mat.aij import MatAIJ
from .ops.stencil_build import as_mat
from .vec.vec import Vec


def _plain(v):
    """Nested tuples of Python scalars (numpy ints and floats unwrapped)."""
    if isinstance(v, (tuple, list)):
        return tuple(_plain(e) for e in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def mat_from_csr(indptr, indices, vals, shape):
    """A port MatAIJ holding a CSR (the reference's ``getValuesCSR()``)."""
    A = MatAIJ()
    A.setSizes(tuple(int(s) for s in shape))
    A.setValuesCSR(indptr, indices, vals)
    return A.assemble()


def _csr_of_device_layout(meta, data):
    """The CSR triple of the reference's ``aij_csr`` or ``aij_ell`` data."""
    if meta[0] == "aij_csr":
        _, m, _ = meta
        rows = np.asarray(data["row_ids"], dtype=np.int64)
        cols, vals = np.asarray(data["col_idx"]), np.asarray(data["vals"])
    else:
        # ELL: ell_scatter holds each CSR entry's flat (row, slot) position,
        # in CSR order, so padding slots are told apart from stored zeros
        _, m, _, K = meta
        pos = np.asarray(data["ell_scatter"], dtype=np.int64)
        rows = pos // K
        cols = np.asarray(data["idx"]).reshape(-1)[pos]
        vals = np.asarray(data["data"]).reshape(-1)[pos]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))])
    return indptr, cols, vals


def mat_from_meta_data(meta, data_np):
    """A port Mat from the reference's ``aij_dnd`` (constant, variable or
    mixed: planes in data["coef"], constants in meta[6]), ``aij_csr``,
    ``aij_ell`` or ``interp_q1`` (meta, data). The stencil's data arrays
    keep their dtype; the assembled layouts become the port's CSR MatAIJ."""
    meta = _plain(meta)
    if meta[0] in ("aij_csr", "aij_ell"):
        return mat_from_csr(*_csr_of_device_layout(meta, data_np), shape=meta[1:3])
    if meta[0] == "interp_q1":
        from .dm.interp import MatInterpQ1
        return MatInterpQ1(meta[1], meta[2], dof=meta[3] if len(meta) > 3 else 1)
    if meta[0] != "aij_dnd":
        raise NotImplementedError(f"interop: operator kind '{meta[0]}' is not ported")
    data = {k: torch.tensor(np.asarray(v), device=config.device())
            for k, v in data_np.items()}
    return as_mat(meta, data)


def _sweep_from_ell(D, X, tab, m, scale=None):
    """The port's Sweep of one factor of the reference's plan: its padded
    ELL block (D values, X columns; a padding slot holds 0.0) and its
    level table (rows per level, padded with the sentinel m)."""
    from .ops.trisolve import sweep_from_levels
    D, X, tab = np.asarray(D), np.asarray(X), np.asarray(tab)
    lev = np.empty(m, dtype=np.int64)
    for lv, row in enumerate(tab):
        lev[row[row < m]] = lv
    keep = D[:m] != 0
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    return sweep_from_levels(lev, indptr, X[:m][keep], D[:m][keep], scale)


def trisolve_plan_from_jax(tail, data_np):
    """The port's trisolve plan (``ops.trisolve.make_trisolve_plan``'s
    (tail, data)) holding the reference's plan: tail (m, nlevL, nlevU)
    and its data as numpy arrays (Ld/Lx/tabL, Ud/Ux/tabU, dinv, and the
    transpose's Utd/Utx/tabUt, Ltd/Ltx/tabLt when present). The rows of
    each level and each row's entries are the reference's (an entry
    stored as 0.0 is taken for padding: it adds nothing)."""
    m, nlevL, nlevU = (int(v) for v in tail)
    d = {k: np.asarray(v) for k, v in data_np.items()}
    dinv = d["dinv"][:m]
    data = {"L": _sweep_from_ell(d["Ld"], d["Lx"], d["tabL"], m),
            "U": _sweep_from_ell(d["Ud"], d["Ux"], d["tabU"], m, dinv)}
    if "Utd" in d:
        data["Ut"] = _sweep_from_ell(d["Utd"], d["Utx"], d["tabUt"], m, dinv)
        data["Lt"] = _sweep_from_ell(d["Ltd"], d["Ltx"], d["tabLt"], m)
    return (m, nlevL, nlevU), data


def vec_from_numpy(arr):
    """A port Vec holding the values of a numpy array (in the real dtype)."""
    return Vec.from_array(np.asarray(arr))
