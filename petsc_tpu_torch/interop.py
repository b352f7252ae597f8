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

With a multi-rank ``comm`` (one process per rank), a reference Vec or
MatAIJ on a sharded comm, and the reference's ``mpiaij`` and ``dnd_mpi``
(meta, data) pairs, become the port's object on each rank: built from the
same global numpy arrays, holding the rank's block, in the same layout
(a declared grid is declared again).
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


def mat_from_csr(indptr, indices, vals, shape, comm=None, grid=None):
    """A port MatAIJ holding a CSR (the reference's ``getValuesCSR()``), on
    `comm` and on the declared grid `grid` where given."""
    A = MatAIJ(comm)
    A.setSizes(tuple(int(s) for s in shape))
    if grid is not None:
        A.setStencilGrid(grid)
    A.setValuesCSR(indptr, indices, vals)
    return A.assemble()


def _mpiaij_csr(meta, d):
    """The global CSR of the reference's mpiaij data: the stacked ELL blocks
    (dd/di, od/oi), the halo's global columns recovered from the plan's
    tables (the all-gather lowering's gidx, or each offset's pack and
    unpack), the spill segments. Zero values (ELL padding) are dropped."""
    Pn, blk, cb, H, sf_meta = meta[1], meta[2], meta[3], meta[6], meta[7]
    a = {k: np.asarray(v) for k, v in d.items() if k not in ("sp", "sf")}
    sf = {k: np.asarray(v) for k, v in d["sf"].items()}
    spl = {k: np.asarray(v) for k, v in d.get("sp", {}).items()}
    garray = np.zeros((Pn, H + 1), dtype=np.int64)
    if sf_meta[0] == "sf_allgather":
        garray[:, :H] = sf["sf_gidx"]
    else:
        for dd in sf_meta[3]:
            pk, up = sf[f"sf_pack_{dd}"], sf[f"sf_unpack_{dd}"]
            for j in range(Pn):
                s_ = (j - dd) % Pn
                garray[s_, up[s_]] = j * cb + pk[j]
    rows, cols, vals = [], [], []
    for s_ in range(Pn):
        r = np.repeat(np.arange(blk), a["dd"].shape[2]) + s_ * blk
        rows += [r, np.repeat(np.arange(blk), a["od"].shape[2]) + s_ * blk]
        cols += [a["di"][s_].reshape(-1) + s_ * cb, garray[s_, a["oi"][s_].reshape(-1)]]
        vals += [a["dd"][s_].reshape(-1), a["od"][s_].reshape(-1)]
        for pre in ("d", "o"):
            if pre + "sv" in spl:
                rows.append(spl[pre + "sr"][s_] + s_ * blk)
                c = spl[pre + "sc"][s_]
                cols.append(c + s_ * cb if pre == "d" else garray[s_, c])
                vals.append(spl[pre + "sv"][s_])
    import scipy.sparse as sp
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    keep = v != 0
    N = Pn * blk
    A = sp.csr_matrix((v[keep], (r[keep], c[keep])), shape=(N, Pn * cb))
    return A


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


def mat_from_meta_data(meta, data_np, comm=None, size=None):
    """A port Mat from the reference's ``aij_dnd`` (constant, variable or
    mixed: planes in data["coef"], constants in meta[6]), ``aij_csr``,
    ``aij_ell`` or ``interp_q1`` (meta, data). The stencil's data arrays
    keep their dtype; the assembled layouts become the port's CSR MatAIJ.
    The sharded ``mpiaij`` and ``dnd_mpi`` pairs become a MatAIJ on `comm`
    (of the logical `size` (m, n) where the padded layout is larger), the
    latter on its grid."""
    if meta[0] in ("mpiaij", "dnd_mpi"):
        from .ops.stencil_build import dnd_to_csr
        if meta[0] == "dnd_mpi":
            shape = tuple(int(v) for v in meta[3])
            offs = _plain(meta[4])
            coef = np.asarray(data_np["coef"], dtype=np.float64)
            planes = np.moveaxis(coef, 0, 1).reshape((len(offs),) + shape)
            A = dnd_to_csr(("aij_dnd", shape, offs, None, None, int(np.prod(shape))),
                           {"coef": planes})
            return mat_from_csr(A.indptr, A.indices, A.data, A.shape, comm, grid=shape)
        A = _mpiaij_csr(_plain(meta[:8]), data_np)
        m, n = size if size is not None else A.shape
        A = A[:m, :n].tocsr()
        return mat_from_csr(A.indptr, A.indices, A.data, A.shape, comm)
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


def vec_from_numpy(arr, comm=None):
    """A port Vec holding the values of a numpy array (in the real dtype);
    on a multi-rank comm, the rank's block of it."""
    return Vec.from_array(np.asarray(arr), comm=comm)


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


def mat_from_jax(M, comm=None):
    """A port Mat holding the same operator as the reference Mat M: a
    MatAIJ from its CSR, a MatSBAIJ from its upper triangle (as a MatSBAIJ,
    block size and ``_bs_sym`` kept), a MatDense from its array, a MatMAIJ
    or MatSchurComplement from its sub-matrices, and the other wrappers
    (and a MatDense) from their (meta, data). A MatAIJ goes onto `comm`,
    its declared grid declared again (a sharded reference MatAIJ in the
    dnd_mpi layout becomes the port's dnd_mpi on a multi-rank comm)."""
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
        sharded = comm is not None and comm.size > 1
        P = mat_from_csr(*M.getValuesCSR(), shape=M.getSize(), comm=comm,
                         grid=getattr(M, "_grid_shape", None) if sharded else None)
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
