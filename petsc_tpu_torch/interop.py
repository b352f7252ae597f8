"""Carry the reference package's state into the port.

The JAX package's operators are ``(meta, data)`` pairs of a plain tuple
and a dict of arrays, and its MatAIJ gives its host CSR through
``getValuesCSR()``; given as numpy arrays, they become the port's objects
on the device of ``config.init``, and so does a trisolve plan of its
``ops/trisolve.py``. :func:`mat_from_jax` carries a reference Mat object
(MatAIJ, MatSBAIJ from its upper CSR, MatDense, MatMAIJ,
MatSchurComplement and the wrappers whose data are arrays) into the port.
The parity tests use this so that both packages compute on the same
operator, factors and vectors.
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
    if meta[0] == "dense" or meta[0].startswith("mat_"):
        return _wrapper_from_meta_data(meta, data_np)
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


def _wrapper_from_meta_data(meta, data):
    """A port Mat from the reference's (meta, data) of a dense or wrapper
    operator, its inner operators carried by :func:`mat_from_meta_data`."""
    from .mat import utility as ut
    from .mat.extra_formats import MatFFT, MatKAIJ
    from .mat.mat import Mat
    kind = meta[0]
    arr = (lambda a: None if a is None or np.ndim(a) == 0 else np.asarray(a))
    if kind == "dense":
        return Mat.createDense((meta[1], meta[2]), array=np.asarray(data["a"]))
    if kind in ("mat_transpose", "mat_normal"):
        cls = ut.MatTranspose if kind == "mat_transpose" else ut.MatNormal
        return cls.create(mat_from_meta_data(meta[1], data["A"]))
    if kind == "mat_diagonal":
        return ut.MatDiagonal.create(np.asarray(data["d"]))
    if kind == "mat_composite":
        return ut.MatComposite.create([mat_from_meta_data(m, d)
                                       for m, d in zip(meta[2], data["mats"])], meta[1])
    if kind == "mat_lrc":
        A = None if meta[1] is None else mat_from_meta_data(meta[1], data["A"])
        return ut.MatLRC.create(A, np.asarray(data["U"]), None if meta[2] else arr(data["C"]),
                                np.asarray(data["V"]))
    if kind == "mat_centering":
        return ut.MatCentering.create(meta[1])
    if kind == "mat_nest":
        blocks = [[None if m is None else mat_from_meta_data(m, d) for m, d in zip(mr, dr)]
                  for mr, dr in zip(meta[3], data["blocks"])]
        return ut.MatNest.create(blocks)
    if kind == "mat_maij":
        return ut.MatMAIJ.create(mat_from_meta_data(meta[1], data["A"]), meta[2])
    if kind == "mat_fft":
        return MatFFT.create(meta[1])
    if kind == "mat_kaij":
        return MatKAIJ.create(mat_from_meta_data(meta[1], data["A"]),
                              arr(data["S"]) if meta[4] else None,
                              arr(data["T"]) if meta[5] else None)
    raise NotImplementedError(f"interop: operator kind '{kind}' is not ported")


def mat_from_jax(M):
    """A port Mat holding the same operator as the reference Mat M: a
    MatAIJ from its CSR, a MatSBAIJ from its upper triangle (as a MatSBAIJ,
    block size and ``_bs_sym`` kept), a MatDense from its array, a MatMAIJ
    or MatSchurComplement from its sub-matrices, and the other wrappers
    (and a MatDense) from their (meta, data)."""
    from .mat import utility as ut
    from .mat.sbaij import MatSBAIJ
    name = type(M).__name__
    if name == "MatSBAIJ":
        ip, ix, v = M.upper_csr()
        P = MatSBAIJ(bs=M._bs_sym)
        P.setSizes(tuple(int(s) for s in M.getSize()))
        P.setValuesCSR(ip, ix, v)
        P.assemble()
        if M.getBlockSize() > 1:
            P.setBlockSize(M.getBlockSize())
        return P
    if name == "MatAIJ":
        P = mat_from_csr(*M.getValuesCSR(), shape=M.getSize())
        if M.getBlockSize() > 1:
            P.setBlockSize(M.getBlockSize())
        return P
    if name == "MatMAIJ":
        return ut.MatMAIJ.create(mat_from_jax(M.getAIJ()), M.dof)
    if name == "MatSchurComplement":
        return ut.MatSchurComplement.create(*[None if B is None else mat_from_jax(B)
                                              for B in M.getSubMatrices()])
    meta = _plain(M.meta)
    return _wrapper_from_meta_data(meta, M.device_data())
