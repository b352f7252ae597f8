"""Factorization preconditioners: ilu, icc, lu, cholesky, bjacobi.

Counterpart of ``petsc_tpu/pc/factor_pc.py`` (PCILU/PCLU,
src/ksp/pc/impls/factor; PCBJacobi, src/ksp/pc/impls/bjacobi/bjacobi.c),
on one device:

* ilu/icc: the host factorization of :mod:`petsc_tpu_torch.mat.factor`
  (ILU(k) by ``-pc_factor_levels``, ILUdt by ``-pc_factor_drop_tolerance``
  and ``-pc_factor_fill``), applied by the level-scheduled sweeps of
  :mod:`petsc_tpu_torch.ops.trisolve` (kernel T1 on the card);
  ``-pc_factor_transpose_solve`` adds the transpose's sweeps.
* lu/cholesky: SuperLU's factors with fill, applied by the same sweeps
  between the row and column permutations (the K8 gather on the card).
* ``-pc_factor_trisolve neumann`` (``-pc_factor_trisolve_sweeps s``,
  default 6): the truncated Neumann series of the strict triangular
  factors, L and U as MatAIJs (on the pmat's grid when it has one: V1 on
  the factors' planes; else S2), y <- b - L y on K2 and
  z <- dinv (y - U z) on N1.
* bjacobi: dropping every entry outside the diagonal blocks and factoring
  what is left gives PETSc's bjacobi with its sub-PC; the level schedule
  then solves the blocks together. Sub-PCs ilu, icc, lu, cholesky and
  jacobi; with ``-sub_ksp_type`` and another sub-PC, an inner KSP (prefix
  ``sub_``) on the block-diagonal matrix, its max_it above 1000 cut to 50.
  As in the reference, ilu, icc, lu and cholesky take precedence over
  ``-sub_ksp_type`` (ROADMAP section 3). On a multi-rank operator with one
  block a rank and sub-PC ilu or icc, the distributed bjacobi
  (factor_pc.py:196-275): each rank factors the diagonal block of its own
  rows (ILU(0), identity on the layout's padding rows) and sweeps it with
  T1 on its block.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..mat import factor
from ..ops import operator, pc_kernels, trisolve
from ..ops.gather_kernels import gather
from ..ops.pallas_kernels import triad
from ..sys.error import Error
from .pc import PC


class _PCFactorBase:
    def __init__(self, pc):
        self.pc = pc

    def _want_transpose(self):
        return bool(self.pc.opt("get_bool", "pc_factor_transpose_solve", default=False))

    def _plan(self, L, U, dinv, perm=None):
        """(meta, data) of the pc_trisolve (or, with perm = (perm_r, perm_c),
        pc_trisolve_perm) binder for the factors."""
        tail, data = trisolve.make_trisolve_plan(L, U, dinv)
        if self._want_transpose():
            data.update(trisolve.make_transpose_tables(L, U, dinv))
        return _with_perm(tail, data, perm, self.pc.pmat.row_layout.Npad)


def _with_perm(tail, data, perm, npad):
    if perm is None:
        return ("pc_trisolve",) + tail + (npad,), data
    perm_r, perm_c = (np.asarray(p, dtype=np.int64) for p in perm)
    dev = config.device()
    # the reference scatters (w[perm] = x); here each scatter is the gather
    # by the inverse permutation, w = x[argsort(perm)]
    for name, p in (("perm_r", perm_r), ("perm_c", perm_c)):
        data[name] = torch.as_tensor(p.astype(np.int32), device=dev)
        data["i" + name] = torch.as_tensor(np.argsort(p).astype(np.int32), device=dev)
    return ("pc_trisolve_perm",) + tail + (npad,), data


class _PCILU(_PCFactorBase):
    def __init__(self, pc):
        super().__init__(pc)
        self.levels = 0
        self.drop_tol = None       # ILUdt through SuperLU's incomplete LU
        self.fill_factor = 10.0

    def set_from_options(self):
        n = self.pc.opt("get_int", "pc_factor_levels", None)
        if n is not None:
            self.levels = n
        dt = self.pc.opt("get_real", "pc_factor_drop_tolerance", None)
        if dt is not None:
            self.drop_tol = dt
        ff = self.pc.opt("get_real", "pc_factor_fill", None)
        if ff is not None:
            self.fill_factor = ff

    def setup(self):
        if self.drop_tol is not None:
            L, U, dinv, perm_r, perm_c = factor.spilu_factors(
                self.pc.pmat.to_scipy(), self.drop_tol, self.fill_factor)
            return self._plan(L, U, dinv, (perm_r, perm_c))
        indptr, indices, vals = self.pc.pmat.getValuesCSR()
        L, U, dinv = factor.iluk(indptr, indices, vals, self.levels)
        if self.pc.opt("get_string", "pc_factor_trisolve", default="levels") == "neumann":
            return _neumann_plan(self.pc, L, U, dinv)
        return self._plan(L, U, dinv)


class _PCLU(_PCFactorBase):
    def setup(self):
        L, U, dinv, perm_r, perm_c = factor.splu_factors(self.pc.pmat.to_scipy())
        return self._plan(L, U, dinv, (perm_r, perm_c))


class _PCBJacobi:
    """Block Jacobi on one device: contiguous near-equal blocks
    (``-pc_bjacobi_blocks``, default 1), each factored by the sub-PC."""

    def __init__(self, pc):
        self.pc = pc
        self.nblocks = None
        self.sub_type = "ilu"
        self.sub_ksp_type = None

    def set_from_options(self):
        nb = self.pc.opt("get_int", "pc_bjacobi_blocks", None)
        if nb:
            self.nblocks = nb
        prefix = self.pc.get_options_prefix()
        st = self.pc.options.get_string("sub_pc_type", prefix=prefix, default=None)
        if st:
            self.sub_type = st
        kt = self.pc.options.get_string("sub_ksp_type", prefix=prefix, default=None)
        if kt and kt != "preonly":
            self.sub_ksp_type = kt

    def setup(self):
        A = self.pc.pmat
        nsh = A.comm.nshards
        if (nsh > 1 and self.nblocks in (None, nsh) and self.sub_type in ("ilu", "icc")
                and not self.sub_ksp_type and hasattr(A, "shardcsr")):
            return self._setup_dist(A)
        m = A.row_layout.N
        nb = self.nblocks or 1
        # contiguous near-equal blocks (PetscLayout's split)
        sizes = np.full(nb, m // nb)
        sizes[: m % nb] += 1
        starts = np.concatenate([[0], np.cumsum(sizes)])
        indptr, indices, vals = A.getValuesCSR()
        rows = np.repeat(np.arange(m), np.diff(indptr))
        blk_of = np.searchsorted(starts, rows, side="right") - 1
        keep = (indices >= starts[blk_of]) & (indices < starts[blk_of + 1])
        bi = np.concatenate([[0], np.cumsum(np.bincount(rows[keep], minlength=m))])
        bj, bv = indices[keep], vals[keep]
        npad = A.row_layout.Npad
        if self.sub_type in ("ilu", "icc"):
            tail, data = trisolve.make_trisolve_plan(*factor.ilu0(bi, bj, bv))
            return _with_perm(tail, data, None, npad)
        if self.sub_type in ("lu", "cholesky"):
            import scipy.sparse as sp
            L, U, dinv, pr, pc_ = factor.splu_factors(sp.csr_matrix((bv, bj, bi), shape=(m, m)))
            tail, data = trisolve.make_trisolve_plan(L, U, dinv)
            return _with_perm(tail, data, (pr, pc_), npad)
        if self.sub_ksp_type:
            return self._sub_ksp(bi, bj, bv, m)
        if self.sub_type == "jacobi":
            d = np.zeros(m)
            hit = bj == rows[keep]
            np.add.at(d, rows[keep][hit], bv[hit])
            inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
            return ("pc_jacobi",), {"inv": torch.as_tensor(inv, dtype=config.real_dtype(),
                                                           device=config.device())}
        raise Error(f"bjacobi: unsupported sub_pc_type {self.sub_type}")

    def _setup_dist(self, A):
        """One block a rank, factored from the rank's own diagonal block of
        the ShardedCSR (no gather; bjacobi.c's per-rank data path); the
        sweeps run on the rank's block."""
        import scipy.sparse as sp
        S = A.shardcsr()
        rl = S.row_layout
        r, blk = A.comm.rank, rl.block
        lo = r * blk
        sub = S.blocks[r][:, lo:lo + blk].tocsr()
        nvalid = rl.local_size(r)
        if nvalid < blk:          # identity on the layout's padding rows
            padd = np.zeros(blk)
            padd[nvalid:] = 1.0
            sub = (sub + sp.diags(padd)).tocsr()
        L, U, dinv = factor.ilu0(sub.indptr.astype(np.int64), sub.indices.astype(np.int64),
                                 sub.data)
        tail, data = trisolve.make_trisolve_plan(L, U, dinv)
        return _with_perm(tail, data, None, blk)

    def _sub_ksp(self, bi, bj, bv, m):
        """The inner KSP (prefix ``sub_``) on the block-diagonal matrix."""
        import scipy.sparse as sp
        from ..ksp.ksp import KSP
        from ..mat.aij import MatAIJ
        from .more_pc import inner_ksp_op
        Abd = MatAIJ.from_scipy(sp.csr_matrix((bv, bj, bi), shape=(m, m)))
        inner = KSP(options=self.pc._options, prefix=(self.pc.get_options_prefix() or "") + "sub_")
        inner.create(self.pc.comm)
        inner.setOperators(Abd, Abd)
        inner.setType(self.sub_ksp_type)
        inner.getPC().setType(self.sub_type)
        inner.setFromOptions()
        if inner.max_it > 1000:
            inner.max_it = 50
        inner.setUp()
        self.sub_ksp = inner
        return inner_ksp_op(inner)


def _neumann_plan(pc, L, U, dinv):
    """The truncated Neumann solves (the reference's factor_pc.py:285-315):
    the strict factors are nilpotent, so (I + L)^-1 b = sum_j (-L)^j b ends
    at the level depth, and s sweeps give a fixed linear preconditioner
    whose apply is 2 s products."""
    import scipy.sparse as sp
    from ..mat.aij import MatAIJ
    s = pc.opt("get_int", "pc_factor_trisolve_sweeps", default=6)
    m = len(dinv)
    gs = getattr(pc.pmat, "_grid_shape", None)
    grid = gs if gs is not None and int(np.prod(gs)) == m else None
    mL, mU = (MatAIJ.from_scipy(sp.csr_matrix((v, ix, ip), shape=(m, m)), grid=grid)
              for ip, ix, v in (L, U))
    rd, dev = config.real_dtype(), config.device()
    data = {"L": mL.device_data(), "U": mU.device_data(),
            "dinv": torch.as_tensor(dinv, dtype=rd, device=dev)}
    return ("pc_trisolve_neumann", mL.meta, mU.meta, int(s), m), data


def _bind_trisolve_neumann(meta, data):
    _, metaL, metaU, s, m = meta
    Lop = operator.bind(metaL, data["L"])
    Uop = operator.bind(metaU, data["U"])
    dinv = data["dinv"]

    def minus(x):
        return torch.full((), -1.0, dtype=x.dtype, device=x.device)

    def mult(b):
        # y = (I + L)^-1 b by y <- b - L y (exact at s >= the depth)
        y = b
        for _ in range(s):
            y = triad(b, Lop.mult(y), minus(b))
        # z = (D + U)^-1 y by z <- dinv (y - U z), from z = dinv y
        z = pc_kernels.neumann_step(dinv, y, torch.zeros_like(y))
        for _ in range(s):
            z = pc_kernels.neumann_step(dinv, y, Uop.mult(z))
        return z

    def mult_t(b):
        # (D + U)^-T = (D + U^T)^-1, then (I + L)^-T = (I + L^T)^-1
        y = pc_kernels.neumann_step(dinv, b, torch.zeros_like(b))
        for _ in range(s):
            y = pc_kernels.neumann_step(dinv, b, Uop.mult_t(y))
        z = y
        for _ in range(s):
            z = triad(y, Lop.mult_t(z), minus(y))
        return z

    return operator.Op(mult=mult, mult_t=mult_t if (Lop.mult_t and Uop.mult_t) else None)


def _bind_trisolve(meta, data):
    def mult(x):
        return trisolve.trisolve_apply(data, x)

    mult_t = None
    if "Ut" in data:        # the transpose's sweeps were made at set-up
        def mult_t(x):
            return trisolve.trisolve_transpose_apply(data, x)

    return operator.Op(mult=mult, mult_t=mult_t)


def _bind_trisolve_perm(meta, data):
    # A = Pr^T (LU) Pc^T, so A^{-1} x = ((LU)^{-1} x[iperm_r])[perm_c]
    def mult(x):
        u = trisolve.trisolve_apply(data, gather(x, data["iperm_r"], check=False))
        return gather(u, data["perm_c"], check=False)

    mult_t = None
    if "Ut" in data:
        # A^{-T} x = ((LU)^{-T} x[iperm_c])[perm_r]
        def mult_t(x):
            u = trisolve.trisolve_transpose_apply(data, gather(x, data["iperm_c"], check=False))
            return gather(u, data["perm_r"], check=False)

    return operator.Op(mult=mult, mult_t=mult_t)


PC.register_impl("ilu", _PCILU)
PC.register_impl("icc", _PCILU)
PC.register_impl("lu", _PCLU)
PC.register_impl("cholesky", _PCLU)
PC.register_impl("bjacobi", _PCBJacobi)
operator.register_binder("pc_trisolve", _bind_trisolve)
operator.register_binder("pc_trisolve_perm", _bind_trisolve_perm)
operator.register_binder("pc_trisolve_neumann", _bind_trisolve_neumann)
