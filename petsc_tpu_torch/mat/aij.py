"""MatAIJ, the assembled sparse matrix, and the `aij_csr` and `aij_dnd` binders.

Counterpart of ``petsc_tpu/mat/aij.py`` (reference MATSEQAIJ,
src/mat/impls/aij/seq/aij.c) for one device:

* Host ("symbolic") state: a canonical CSR over the rows in numpy/scipy,
  as in the reference: assembly from setValues, CSR or COO triplets, and
  the host matrix operations. ``from_scipy(..., host_only=True)`` keeps a
  matrix on the host until its device arrays are asked for (a Pmat that
  only drives a preconditioner's set-up).
* Device ("numeric") state: CSR arrays (int64 row pointers, int32
  columns, values, the diagonal and its positions). The product is the
  hand kernel S2 (:func:`ops.pallas_kernels.csr_spmv`). The TPU package
  chose among no-gather layouts (DIA, HYB, BDIA, RCM-permuted, ELL);
  Hopper has a hardware gather, so every layout name it accepts gives
  CSR here, with the same results. A matrix whose rows are the points of
  a declared grid (``setStencilGrid``) and whose pattern decomposes into
  grid offsets takes the ``aij_dnd`` layout instead (one coefficient
  plane per offset, product on V1), as in the reference.
* COO assembly (gcreate.c:706): the pattern is sorted on the host once;
  each ``setValuesCOO`` then runs on the device (:func:`ops.spmv.coo_scatter_csr`):
  the K8 gather ``v[perm]``
  (:func:`ops.gather_kernels.gather`), a segmented sum only where the
  pattern has duplicates, and the diagonal refreshed through K8.
* Sparse products (matMult, transposeMatMult, ptap, rart) run on the
  host CSRs through the port's native Gustavson kernel
  (:mod:`petsc_tpu_torch.native`), as in the reference (aij.py:1185-1231).

Every value change bumps the object state, so a cache keyed on it (the
PC's setup) never applies stale values.

On a multi-rank comm (:mod:`..parallel.mesh`, one process per rank) every
rank holds the global host CSR (host set-up runs the same on every rank)
and puts only its own rows on its device, in one of the reference's two
distributed layouts (aij.py:916-1110, :1589-1740):

* ``mpiaij`` (MPIAIJHEADER, mpiaij.h:40-74): the rank's diagonal block and
  its off-diagonal block (columns compacted to the halo, garray) as CSR on
  S2, the halo moved by an :class:`..parallel.sf.ExchangePlan` over the
  column layout. ``mult`` keeps MatMult_MPIAIJ's order (mpiaij.c:1052):
  the exchange issued, the diagonal product, the wait, the off-diagonal
  product on the halo, the two summed by K2. ``mult_t`` runs S2 on the
  explicit local transposes and sends the halo rows' contributions back by
  the plan's ``reduce_add``.
* ``dnd_mpi`` (a grid declared by ``setStencilGrid`` whose slowest axis
  divides over the ranks, with each rank's ``nzl`` planes at least the
  stencil's reach s): the rank's coefficient planes of its slab. ``mult``
  sends s boundary planes to each neighbour (the end ranks receive zeros,
  as ``ppermute`` gives them), copies the slab once into a buffer with s
  halo planes on each side (the reference concatenates, aij.py:1611) and
  runs V1 on it; its planes carry zero coefficients on the halo rows, so
  the slab's rows are the product and the halo rows are dropped.
  ``mult_t`` runs V1T on the buffer with zero halos and sends the halo
  rows back to be added by K2.

``setValuesCOO`` stays on the device there too: each rank keeps the COO
plan of its own rows' entries, sums them (K8, and the segmented sum where
entries repeat) into its run of CSR values, and moves that run into its
layout, mpiaij's two blocks by K8 gathers, a slab's planes by one scatter;
the host CSR's values come back (one all-gather) only when asked for.

``from_sharded`` binds a :class:`.shardcsr.ShardedCSR` (the distributed
GAMG set-up's levels) without a global CSR; ``to_scipy`` then collapses it.

A matrix with a block size above 1 (``setSizes(bs=)``, ``setBlockSize``)
takes the block layout ``aij_bsr``: BSR (int64 block-row pointers, int32
block columns, values (nblocks, bs, bs) row-major), product on the hand
kernel B1 (:func:`ops.block_kernels.bsr_spmv`), its transpose on B1 over
the block transpose built once at the first call. It stands for both of
the reference's block layouts (block-ELL ``bell`` and the no-gather block
stencil ``dndb``, aij.py:1456-1515), whose padding and planes serve the
TPU's lack of a gather; the results are the same.

The `aij_dnd` binder is the reference's ``_bind_aij_dnd``: a
uniform-coefficient full box or star stencil (the separable branch,
aij.py:1346-1379) is applied by the hand-written S1 kernel
(:func:`ops.pallas_kernels.const_stencil`); every other stencil (planes,
planes mixed with constants, constants on other offsets: the slab and
generic branches, :1381-1436) by V1 (:func:`ops.grid_kernels.dnd_stencil`).
The TPU's slab chunking is a VMEM device and is not carried over; both
reference branches give the same y. The variable-coefficient transpose
(:1438-1451) is V1T (:func:`ops.grid_kernels.dnd_stencil_t_fn`: V1's generic
kernel on shifted planes, one copy of the planes on the card, kept in the
data as ``dnd_t`` until the values change).
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from .. import config, native
from ..ops import operator, spmv
from ..ops.block_kernels import bsr_spmv, bsr_transpose
from ..ops.gather_kernels import gather
from ..ops.grid_kernels import dnd_stencil_fn, dnd_stencil_t_fn
from ..ops.pallas_kernels import const_stencil, csr_spmm, csr_spmv, triad
from ..parallel.layout import Layout
from ..sys.error import Error
from ..vec.vec import InsertMode, NormType
from .mat import Mat

# -mat_spmv_kind values: the TPU's no-gather layouts all give CSR here,
# its two block layouts the BSR layout
_CSR_KINDS = ("auto", "csr", "ell", "dia", "hyb", "bdia", "perm")
_BLOCK_KINDS = ("bell", "dndb")
_MAX_GRID_OFFSETS = 80      # the reference's limit on a grid pattern's offsets
_INT32_MAX = 2 ** 31 - 1


def _sort_key(i, j, ncols):
    """int64 key whose stable order is (row, column) order."""
    return i * np.int64(max(ncols, 1)) + j


def _coo_positions(rows, hit, blk, dev):
    """The position of each local row's diagonal entry in the rank's run of
    CSR values (-1 where it has none), for the diagonal's refresh."""
    dpos = np.full(blk, -1, dtype=np.int32)
    dpos[rows[hit]] = np.nonzero(hit)[0]
    return {"diag_pos": torch.as_tensor(dpos, device=dev)}


def _row_of_entry(indptr):
    return np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))


def _unique_offsets(d, shape):
    """np.unique(d, axis=0, return_inverse=True) for the (nnz, ndim) grid
    offsets d (|d| < shape per axis), through one int64 key per entry in
    mixed radix, the first axis most significant: the same rows in the same
    (lexicographic) order, from a 1-D sort in place of the row sort (13 of
    compute_operators' 16 s at 97^3 on the CPU)."""
    span = 2 * np.asarray(shape, dtype=np.int64) - 1
    key = np.zeros(len(d), dtype=np.int64)
    for ax in range(len(shape)):
        key = key * span[ax] + (d[:, ax] + (shape[ax] - 1))
    ukey, inv = np.unique(key, return_inverse=True)
    uniq = np.empty((len(ukey), len(shape)), dtype=d.dtype)
    for ax in range(len(shape) - 1, -1, -1):
        uniq[:, ax] = ukey % span[ax] - (shape[ax] - 1)
        ukey = ukey // span[ax]
    return uniq, inv.reshape(-1)


class MatAIJ(Mat):
    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        # assembly staging (COO triplets, numpy)
        self._sti: list = []
        self._stj: list = []
        self._stv: list = []
        self._st_mode = None
        # canonical host CSR
        self._indptr = None   # (m+1,) int64
        self._indices = None  # (nnz,) int64
        self._vals = None     # (nnz,) float64; None while the device holds newer values
        # device state
        self._dev = None
        self._meta = None
        self._coo_plan = None
        self._kind_opt = None
        self._assembled = False
        self.host_only = False
        self._grid_shape = None
        self._grid_off_cache = None
        self._bsr_scatter = None   # host: each CSR entry's slot in the BSR values

    # ================= assembly =================

    def setPreallocation(self, nz=None, nnz=None):
        return self  # growth is dynamic on the host

    def setValues(self, rows, cols, values, addv=InsertMode.INSERT_VALUES):
        """Stage a dense len(rows) x len(cols) block (MatSetValues,
        matrix.c:1568). Negative indices are skipped."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        values = np.asarray(values, dtype=np.float64).reshape(len(rows), len(cols))
        ii = np.repeat(rows, len(cols))
        jj = np.tile(cols, len(rows))
        vv = values.reshape(-1)
        keep = (ii >= 0) & (jj >= 0)
        if self._st_mode is not None and self._st_mode != addv:
            raise Error("cannot mix INSERT_VALUES and ADD_VALUES in one assembly")
        self._st_mode = addv
        self._sti.append(ii[keep])
        self._stj.append(jj[keep])
        self._stv.append(vv[keep])

    def setValue(self, i, j, v, addv=InsertMode.INSERT_VALUES):
        self.setValues([i], [j], [[v]], addv)

    def setValuesCSR(self, indptr, indices, values):
        """Take a CSR (copied); column indices are sorted within each row."""
        self._indptr = np.array(indptr, dtype=np.int64)
        self._indices = np.array(indices, dtype=np.int64)
        self._vals = np.array(values, dtype=np.float64)
        self._coo_plan = None
        if len(self._indices):
            dec = np.diff(self._indices) < 0
            if dec.any():
                rows = _row_of_entry(self._indptr)
                if (dec & (np.diff(rows) == 0)).any():
                    order = np.argsort(_sort_key(rows, self._indices, self.col_layout.N),
                                       kind="stable")
                    self._indices = self._indices[order]
                    self._vals = self._vals[order]

    def assemblyBegin(self, *a):
        pass

    def assemblyEnd(self, *a):
        self.assemble()

    def assemble(self, *a):
        """Merge staged triplets into the canonical CSR and rebuild the
        device arrays (MatAssemblyBegin/End, matrix.c:6255/6318)."""
        self._merge_staged()
        self._refresh_device()
        self._assembled = True
        self.increase_state()
        return self

    def _merge_staged(self):
        """The staged triplets merged into the host CSR (an empty CSR when
        there is none), the device copy left as it is."""
        if self._sti:
            i = np.concatenate(self._sti)
            j = np.concatenate(self._stj)
            v = np.concatenate(self._stv)
            if self._indptr is not None:
                self._sync_host_vals()
                i = np.concatenate([_row_of_entry(self._indptr), i])
                j = np.concatenate([self._indices, j])
                v = np.concatenate([self._vals, v])
            if self._st_mode == InsertMode.INSERT_VALUES:
                self._dedupe_last_wins(i, j, v)
            else:
                self._dedupe_sum(i, j, v)
            self._sti, self._stj, self._stv, self._st_mode = [], [], [], None
            self._coo_plan = None      # the pattern may have changed
        if self._indptr is None:
            self._indptr = np.zeros(self.row_layout.N + 1, dtype=np.int64)
            self._indices = np.zeros(0, dtype=np.int64)
            self._vals = np.zeros(0, dtype=np.float64)

    def _check_bounds(self, i, j):
        m, n = self.getSize()
        if len(i) and (int(i.max()) >= m or int(j.max()) >= n):
            raise Error(f"MatAIJ: entry ({int(i.max())}, {int(j.max())}) outside the "
                        f"{m} x {n} matrix")

    def _dedupe_sum(self, i, j, v):
        """Canonical CSR from triplets, duplicates summed in their order."""
        self._check_bounds(i, j)
        order = np.argsort(_sort_key(i, j, self.col_layout.N), kind="stable")
        i, j, v = i[order], j[order], v[order]
        new = np.ones(len(i), dtype=bool)
        new[1:] = (i[1:] != i[:-1]) | (j[1:] != j[:-1])
        slots = np.cumsum(new) - 1
        self._vals = np.bincount(slots, weights=v, minlength=int(new.sum())) \
            if len(v) else np.zeros(0)
        self._indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(i[new], minlength=self.row_layout.N))]).astype(np.int64)
        self._indices = j[new]

    def _dedupe_last_wins(self, i, j, v):
        self._check_bounds(i, j)
        order = np.argsort(_sort_key(i, j, self.col_layout.N), kind="stable")
        i, j, v = i[order], j[order], v[order]
        last = np.ones(len(i), dtype=bool)
        last[:-1] = (i[1:] != i[:-1]) | (j[1:] != j[:-1])
        self._dedupe_sum(i[last], j[last], v[last])

    # -------- COO device-resident assembly (gcreate.c:706 model) --------

    def setPreallocationCOO(self, coo_i, coo_j):
        """Symbolic phase: fix the COO pattern (negative indices dropped)
        and build the device plan. The dropped entries are folded into
        the permutation, so ``setValuesCOO`` is one gather on the card."""
        i = np.asarray(coo_i, dtype=np.int64).reshape(-1)
        j = np.asarray(coo_j, dtype=np.int64).reshape(-1)
        if len(i) != len(j):
            raise Error(f"setPreallocationCOO: {len(i)} rows and {len(j)} columns")
        src = self._coo_plan.get("src") if self._coo_plan is not None else None
        if src is not None and np.array_equal(src[0], i) and np.array_equal(src[1], j):
            # the same (i, j) again (a Newton step's Jacobian callback): the
            # plan and the device layout stand, and the values are zero as
            # after a fresh preallocation
            self._zero_values()
            self.increase_state()
            return self
        n_user = len(i)
        i_user, j_user = i.copy(), j.copy()
        if n_user > _INT32_MAX:
            raise Error("setPreallocationCOO: the device plan's int32 gather takes "
                        "fewer than 2^31 entries")
        keep = (i >= 0) & (j >= 0)
        kept = None if keep.all() else np.nonzero(keep)[0]
        if kept is not None:
            i, j = i[kept], j[kept]
        self._check_bounds(i, j)
        # one stable sort of the int64 key i*ncols + j: the (row, col) order
        order = np.argsort(_sort_key(i, j, self.col_layout.N), kind="stable")
        si, sj = i[order], j[order]
        new = np.ones(len(si), dtype=bool)
        new[1:] = (si[1:] != si[:-1]) | (sj[1:] != sj[:-1])
        self._indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(si[new], minlength=self.row_layout.N))]).astype(np.int64)
        self._indices = sj[new]
        self._vals = np.zeros(len(self._indices))
        dev = config.device()
        perm = order if kept is None else kept[order]
        # CSR slot of each sorted entry; only needed where entries repeat
        slot = None if new.all() else np.cumsum(new) - 1
        nnz = len(self._indices)
        if self.comm.nshards > 1:
            # a rank keeps the plan of its own rows' entries (a run of the
            # sorted order), their slots counted from its first
            lo, hi = self.row_layout.range(self.comm.rank)
            p0, p1 = int(self._indptr[lo]), int(self._indptr[hi])
            q0, q1 = (p0, p1) if slot is None else np.searchsorted(slot, [p0, p1])
            perm, nnz = perm[q0:q1], p1 - p0
            slot = None if slot is None else slot[q0:q1] - p0
        self._coo_plan = {
            "perm": torch.as_tensor(perm.astype(np.int32), device=dev),
            "seg": None if slot is None else torch.as_tensor(slot, dtype=torch.int64,
                                                             device=dev),
            "n_user": n_user,
            "nnz": nnz,
            "src": (i_user, j_user),
        }
        self._refresh_device()
        self._assembled = True
        self.increase_state()
        return self

    def setValuesCOO(self, values):
        """Numeric phase, on the device: csr_vals = segment sum of v[perm].
        On a multi-rank comm every rank takes all the values and sums its
        own rows' into its blocks (``_update_device_values``)."""
        plan = self._coo_plan
        if plan is None:
            raise Error("call setPreallocationCOO first (a later assembly that "
                        "changes the pattern drops the COO plan)")
        v = torch.as_tensor(values, dtype=config.real_dtype(),
                            device=config.device()).reshape(-1).contiguous()
        if v.numel() != plan["n_user"]:
            raise Error(f"setValuesCOO: {v.numel()} values for {plan['n_user']} entries")
        if self._meta[0] == "aij_bsr" and plan.get("bsr_perm") is not None:
            # every block slot holds one entry and no entry repeats: the
            # BSR values are one K8 gather of the user's values
            self._set_block_values(gather(v, plan["bsr_perm"], check=False))
        else:
            self._update_device_values(
                spmv.coo_scatter_csr(plan["perm"], plan["seg"], v, plan["nnz"], check=False))
        self._vals = None      # the host copy is fetched when it is asked for
        self._assembled = True
        self.increase_state()
        return self

    # ================= host CSR access =================

    def getValuesCSR(self):
        if self._indptr is None and getattr(self, "_sharded_src", None) is not None:
            A = self.to_scipy()
            return A.indptr.astype(np.int64), A.indices.astype(np.int64), A.data.copy()
        self._sync_host_vals()
        return self._indptr.copy(), self._indices.copy(), self._vals.copy()

    def _sync_host_vals(self):
        if self._vals is None:
            dev = self._dev
            if self.comm.nshards > 1:
                self._vals = self._gather_rank_vals()
                return
            # a grid layout keeps its values in the planes only, a block
            # layout in its blocks
            if "bvals" in dev:
                self._vals = dev["bvals"].reshape(-1).cpu().numpy().astype(np.float64)[
                    self._bsr_scatter]
                return
            vals = dev["vals"] if "vals" in dev else \
                dev["coef"].reshape(-1)[dev["dnd_scatter"]]
            self._vals = vals.cpu().numpy().astype(np.float64)

    def _gather_rank_vals(self):
        """The global CSR values from every rank's device blocks, after a
        setValuesCOO on a multi-rank comm: each rank's run of them read
        back through its COO positions, then one all-gather (a collective,
        which every rank makes)."""
        dev, rl, P = self._dev, self.row_layout, self.comm.nshards
        if self._meta[0] == "mpiaij":
            d, o = dev["d"]["vals"], dev["o"]["vals"]
            lv = torch.empty(d.numel() + o.numel(), dtype=d.dtype, device=d.device)
            lv[dev["d_src"].long()] = d
            lv[dev["o_src"].long()] = o
        else:
            lv = dev["coef"].reshape(-1)[dev["dnd_scatter"]]
        counts = np.diff([int(self._indptr[rl.range(s)[0]]) for s in range(P)]
                         + [int(self._indptr[-1])])
        width = max(int(counts.max()), 1)
        buf = torch.zeros(width, dtype=lv.dtype, device=lv.device)
        buf[: lv.numel()] = lv
        every = self.comm.allgather(buf).cpu().numpy().reshape(P, width)
        return np.concatenate([every[s, : counts[s]] for s in range(P)]).astype(np.float64)

    def to_scipy(self):
        import scipy.sparse as sp
        src = getattr(self, "_sharded_src", None)
        if src is not None and self._indptr is None:
            return src.to_global_csr()[:, : self.col_layout.N].tocsr()
        self._sync_host_vals()
        return sp.csr_matrix((self._vals, self._indices, self._indptr), shape=self.getSize())

    @classmethod
    def from_scipy(cls, A, comm=None, host_only=False, grid=None):
        """A MatAIJ holding the scipy matrix A, on the structured grid `grid`
        when one is given (declared before the one device build).
        host_only=True keeps it a host object (a Pmat for a preconditioner's
        set-up) and defers the device build until meta or device_data is
        asked for. The reference's
        contract (aij.py:244-256): a host_only Pmat is the numerically
        identical twin of its Amat, which PCGAMG then applies on the finest
        level."""
        A = A.tocsr()
        M = cls(comm)
        M.host_only = bool(host_only)
        M.setSizes(A.shape)
        if grid is not None:
            M.setStencilGrid(grid)
        M.setValuesCSR(A.indptr, A.indices, A.data)
        return M.assemble()

    def nnz(self):
        if self._indptr is not None:
            return int(self._indptr[-1])
        src = getattr(self, "_sharded_src", None)
        return src.nnz() if src is not None else 0

    def getRow(self, row):
        self._sync_host_vals()
        lo, hi = self._indptr[row], self._indptr[row + 1]
        return self._indices[lo:hi].copy(), self._vals[lo:hi].copy()

    def getInfo(self):
        return {"nz_allocated": self.nnz(), "nz_used": self.nnz(),
                "memory": self.nnz() * 12.0, "assemblies": 1}

    # ================= device build =================

    def _choose_kind(self):
        """The GPU layout policy for a single-device matrix (the reference's
        -mat_spmv_kind choice, aij.py:307-355): "bsr" for a block size above
        1 shared by rows and columns (under auto) or where -mat_spmv_kind
        bell or dndb asks for it; "dnd" where the pattern decomposes on a
        declared grid (under auto) or where -mat_spmv_kind dnd asks for it;
        else "csr"."""
        if self._kind_opt is None:
            self._kind_opt = self.opt("get_string", "mat_spmv_kind", default="auto")
        kind = self._kind_opt
        bs = self.row_layout.bs
        if kind in _BLOCK_KINDS or (kind == "auto" and bs > 1 and bs == self.col_layout.bs):
            if bs != self.col_layout.bs:
                raise Error(f"-mat_spmv_kind {kind}: row block size {bs} and column block "
                            f"size {self.col_layout.bs} differ")
            return "bsr"
        if kind == "dnd":
            if self._grid_offsets() is None:
                raise Error("-mat_spmv_kind dnd: the matrix declares no grid (setStencilGrid) "
                            "on which its pattern decomposes")
            return "dnd"
        if kind not in _CSR_KINDS:
            raise Error(f"unknown -mat_spmv_kind '{kind}'")
        if kind == "auto" and len(self._indices) and self._grid_offsets() is not None:
            return "dnd"
        return "csr"

    def setStencilGrid(self, shape):
        """Declare that rows and columns are the points of a structured grid
        of the given (..., ny, nx) shape, x fastest (DMDA natural order):
        a pattern that decomposes into grid offsets then takes the aij_dnd
        layout, and PCGAMG the structured head (aij.py:418-428)."""
        self._grid_shape = tuple(int(s) for s in shape)
        self._grid_off_cache = None
        if self._assembled and self._indptr is not None:
            self._refresh_device()
            self.increase_state()
        return self

    def _grid_offsets(self):
        """(unique offsets, each entry's offset index, each entry's row) when
        rows and columns live on a declared grid of two or more axes and the
        pattern decomposes into at most 80 offsets; else None
        (aij.py:430-463)."""
        cache = self._grid_off_cache
        if cache is not None and cache[0] is self._indices:
            return cache[1]
        shape, out = self._grid_shape, None
        m, n = self.getSize()
        if (shape is not None and len(shape) >= 2 and m == n == int(np.prod(shape))
                and len(self._indices)):
            rows = _row_of_entry(self._indptr)
            ri = np.stack(np.unravel_index(rows, shape), axis=1)
            ci = np.stack(np.unravel_index(self._indices, shape), axis=1)
            d = ci - ri                              # (nnz, ndim) exact offsets
            if not np.any(np.abs(d).max(axis=0) >= np.asarray(shape)):
                uniq, inv = _unique_offsets(d, shape)
                if len(uniq) <= _MAX_GRID_OFFSETS:
                    out = (uniq, inv, rows)
        self._grid_off_cache = (self._indices, out)
        return out

    def _relayout(self):
        """A new block size: the device copy is laid out again, the old one
        dropped first so that the card never holds both."""
        if self._assembled and self._indptr is not None:
            self._sync_host_vals()
            self._dev = self._meta = None
            self._refresh_device()
            self.increase_state()

    def _refresh_device(self):
        """Rebuild the device arrays from the host CSR, or drop them on a
        host_only matrix (rebuilt from the updated CSR when next asked for)."""
        if self.host_only:
            self._dev = self._meta = None
        else:
            self._build_device()

    def _build_device(self):
        if self.comm.nshards > 1:
            self._build_device_mpi()
            return
        m, n = self.getSize()
        kind = self._choose_kind()
        indptr, indices = self._indptr, self._indices
        self._sync_host_vals()
        if len(indices) > _INT32_MAX:
            raise Error("MatAIJ: the device CSR's int32 gathers take fewer than 2^31 "
                        "stored entries")
        rows = _row_of_entry(indptr)
        hit = np.nonzero(indices == rows)[0]
        dpos = np.full(m, -1, dtype=np.int32)
        dpos[rows[hit]] = hit
        diag = np.bincount(rows[hit], weights=self._vals[hit], minlength=m)
        dev, rd = config.device(), config.real_dtype()
        self._dev = {
            # diagonal cached for PC jacobi, and its CSR positions so that the
            # COO numeric path refreshes it on the device
            "diag": torch.as_tensor(diag, dtype=rd, device=dev),
            "diag_pos": torch.as_tensor(dpos, device=dev),
        }
        if kind == "dnd":
            # one coefficient plane per grid offset (aij.py:652-672), and each
            # CSR entry's place in the planes for device numeric updates
            shape = self._grid_shape
            uniq, inv, rows = self._grid_offsets()
            K = len(uniq)
            coef = np.zeros((K,) + shape)
            coef[(inv,) + np.unravel_index(rows, shape)] = self._vals
            self._dev["coef"] = torch.as_tensor(coef, dtype=rd, device=dev)
            self._dev["dnd_scatter"] = torch.as_tensor(inv * int(np.prod(shape)) + rows,
                                                       device=dev)
            lpad = tuple(int(max(0, -uniq[:, ax].min())) for ax in range(len(shape)))
            rpad = tuple(int(max(0, uniq[:, ax].max())) for ax in range(len(shape)))
            self._meta = ("aij_dnd", shape, tuple(tuple(int(v) for v in o) for o in uniq),
                          lpad, rpad, n)
            return
        if kind == "bsr":
            self._build_bsr(rows, dpos, dev, rd)
            return
        self._dev.update(indptr=torch.as_tensor(indptr, dtype=torch.int64, device=dev),
                         col=torch.as_tensor(indices.astype(np.int32), device=dev),
                         vals=torch.as_tensor(self._vals, dtype=rd, device=dev))
        self._meta = ("aij_csr", m, n)

    def _build_bsr(self, rows, dpos, dev, rd):
        """The BSR layout (the reference's bell build, aij.py:675-704, without
        its padding to Kb blocks per row): the blocks of each block row in
        column order; the CSR entries' slots kept on the host for value
        updates and downloads; the diagonal's positions moved to the BSR
        values; and, for a COO pattern whose entries fill every block slot
        once, the COO permutation composed into the block order."""
        m, n = self.getSize()
        bs = self.row_layout.bs
        mb, nb = m // bs, n // bs
        indices = self._indices
        key = (rows // bs) * nb + indices // bs
        uk, blk = np.unique(key, return_inverse=True)
        blk = blk.reshape(-1)
        bptr = np.concatenate([[0], np.cumsum(np.bincount(uk // nb, minlength=mb))])
        slot = blk * (bs * bs) + (rows % bs) * bs + indices % bs
        del key, blk
        bvals = np.zeros(len(uk) * bs * bs)
        bvals[slot] = self._vals
        self._bsr_scatter = slot
        dslot = np.where(dpos >= 0, slot[np.maximum(dpos, 0)], -1) if len(slot) else dpos
        self._dev["diag_pos"] = torch.as_tensor(dslot.astype(np.int32), device=dev)
        self._dev.update(bptr=torch.as_tensor(bptr, dtype=torch.int64, device=dev),
                         bcol=torch.as_tensor((uk % nb).astype(np.int32), device=dev),
                         bvals=torch.as_tensor(bvals, dtype=rd, device=dev).view(-1, bs, bs))
        plan = self._coo_plan
        if plan is not None:
            plan["bsr_perm"] = None
            if plan["seg"] is None and len(slot) == len(bvals):
                perm = torch.empty(len(slot), dtype=torch.int32, device=dev)
                perm[torch.as_tensor(slot, device=dev)] = plan["perm"]
                plan["bsr_perm"] = perm
        self._meta = ("aij_bsr", m, n, bs)

    def _set_block_values(self, flat):
        """New BSR values (flat, in block order) for the same pattern, on the
        device; the diagonal refreshed through K8."""
        bs = self._meta[3]
        self._dev["bvals"] = flat.view(-1, bs, bs)
        self._dev.pop("bsr_t", None)
        self._refresh_diag(flat)

    def _refresh_diag(self, flat):
        dpos = self._dev["diag_pos"]
        if flat.numel():
            d = gather(flat, dpos.clamp(min=0), check=False)
            self._dev["diag"] = torch.where(dpos >= 0, d, torch.zeros((), dtype=d.dtype,
                                                                      device=d.device))
        else:
            self._dev["diag"] = torch.zeros_like(self._dev["diag"])

    def _zero_values(self):
        """Every stored value zero, on the host and the device, with the
        pattern and the device layout kept (no kernel launch)."""
        self._vals = np.zeros(len(self._indices))
        if self._dev is not None:
            for key in ("vals", "coef", "bvals", "diag"):
                if key in self._dev:
                    self._dev[key] = torch.zeros_like(self._dev[key])
            for key in ("d", "o"):          # the mpiaij blocks
                if key in self._dev:
                    self._dev[key]["vals"] = torch.zeros_like(self._dev[key]["vals"])
                    self._dev[key].pop("csr_t_vals", None)
            for key in ("csr_t_vals", "dnd_t", "bsr_t"):
                self._dev.pop(key, None)

    def _update_device_values(self, csr_vals):
        """New CSR values for the same pattern, staying on the device (a
        grid layout scatters them into its planes, a block layout into its
        blocks; each entry has a slot of its own, so the writes do not
        collide). On a multi-rank comm `csr_vals` are the rank's run of
        them: an mpiaij layout takes its two blocks' values by K8 gathers,
        a slab its planes (halo planes left zero)."""
        if self._meta[0] == "mpiaij":
            for key in ("d", "o"):
                blk = self._dev[key]
                blk["vals"] = gather(csr_vals, self._dev[key + "_src"], check=False)
                blk.pop("csr_t_vals", None)       # the transpose's values are stale
            self._refresh_diag(csr_vals)
            return
        if self._meta[0] == "aij_bsr":
            flat = torch.zeros(self._dev["bvals"].numel(), dtype=csr_vals.dtype,
                               device=csr_vals.device)
            flat[torch.as_tensor(self._bsr_scatter, device=csr_vals.device)] = csr_vals
            self._set_block_values(flat)
            return
        if self._meta[0] in ("aij_dnd", "dnd_mpi"):
            coef = self._dev["coef"]
            flat = torch.zeros(coef.numel(), dtype=csr_vals.dtype, device=csr_vals.device)
            flat[self._dev["dnd_scatter"]] = csr_vals
            self._dev["coef"] = flat.reshape(coef.shape)
            self._dev.pop("dnd_t", None)          # V1T's planes are stale
        else:
            self._dev["vals"] = csr_vals
            self._dev.pop("csr_t_vals", None)     # the transpose's values are stale
        self._refresh_diag(csr_vals)

    @property
    def meta(self):
        if self._meta is None and self.host_only and self._indptr is not None:
            self._build_device()
        return self._meta

    def device_data(self):
        if self._dev is None and self.host_only and self._indptr is not None:
            self._build_device()
        return self._dev

    # ================= distributed build (one process per rank) =================

    def shardcsr(self):
        """The per-rank row-block representation for distributed set-up
        (ShardedCSR, aij.py:267-294); columns stay in the global padded
        space."""
        import scipy.sparse as sp
        from .shardcsr import ShardedCSR
        src = getattr(self, "_sharded_src", None)
        if src is not None:
            return src
        self._sync_host_vals()
        rl, cl = self.row_layout, self.col_layout
        blocks = []
        for s in range(rl.nshards):
            lo, hi = rl.range(s)
            p0, p1 = self._indptr[lo], self._indptr[hi]
            ip = (self._indptr[lo:hi + 1] - p0).astype(np.int64)
            if hi - lo < rl.block:
                ip = np.concatenate([ip, np.full(rl.block - (hi - lo), ip[-1], dtype=np.int64)])
            blocks.append(sp.csr_matrix((self._vals[p0:p1], self._indices[p0:p1], ip),
                                        shape=(rl.block, cl.Npad)))
        return ShardedCSR(blocks, Layout(rl.N, nshards=rl.nshards),
                          Layout(cl.N, nshards=cl.nshards))

    def _build_device_mpi(self):
        """The rank's rows in the dnd_mpi slab layout where the grid allows
        it, else in the mpiaij layout (aij.py:916-933)."""
        self._sync_host_vals()
        if self._build_device_dnd_mpi():
            return
        rl = self.row_layout
        indptr, indices, vals = self._indptr, self._indices, self._vals
        per_shard = []
        for s in range(rl.nshards):
            lo, hi = rl.range(s)
            p0, p1 = indptr[lo], indptr[hi]
            rows = np.repeat(np.arange(hi - lo), np.diff(indptr[lo:hi + 1]))
            per_shard.append((rows, indices[p0:p1], vals[p0:p1]))
        self._finish_build_mpi(per_shard, coo_positions=self._coo_plan is not None)

    def _finish_build_mpi(self, per_shard_coo, coo_positions=False):
        """The mpiaij layout from every rank's (local rows, global columns,
        values) triples (aij.py:990-1095): each rank's garray (its distinct
        off-diagonal columns) makes the plan's leaves, and this rank's two
        blocks go to its device as CSR. With `coo_positions` (triples in
        the order of a canonical CSR, as a COO pattern gives them) each
        block entry's position in the rank's run of CSR values is kept too,
        for setValuesCOO: a block keeps the run's order, so its positions
        are those of the entries it takes."""
        import scipy.sparse as sp
        from ..parallel.sf import ExchangePlan
        comm, rl, cl = self.comm, self.row_layout, self.col_layout
        r, blk, cb = comm.rank, rl.block, cl.block
        garrays = [np.unique(c[(c // cb) != s]) for s, (_, c, _) in enumerate(per_shard_coo)]
        plan = ExchangePlan(cl, garrays, axis=comm.axis, comm=comm)
        rows, cols, v = per_shard_coo[r]
        dg = (cols // cb) == r
        ga = garrays[r]
        dev, rd = config.device(), config.real_dtype()

        def block(sel, c, ncols):
            A = sp.csr_matrix((v[sel], (rows[sel], c)), shape=(blk, ncols))
            A.sum_duplicates()
            return {"indptr": torch.as_tensor(A.indptr.astype(np.int64), device=dev),
                    "col": torch.as_tensor(A.indices.astype(np.int32), device=dev),
                    "vals": torch.as_tensor(A.data, dtype=rd, device=dev)}, A.nnz

        d, dnnz = block(dg, cols[dg] - r * cb, cb)
        o, onnz = block(~dg, np.searchsorted(ga, cols[~dg]), plan.H)
        hit = dg & (cols - r * cb == rows)
        diag = np.bincount(rows[hit], weights=v[hit], minlength=blk)
        self._dev = {"d": d, "o": o, "sf": plan,
                     "diag": torch.as_tensor(diag, dtype=rd, device=dev)}
        if coo_positions:
            if dnnz + onnz != len(cols):
                raise Error("MatAIJ: a COO pattern's CSR repeats an entry")
            self._dev.update(_coo_positions(rows, hit, blk, dev),
                             d_src=torch.as_tensor(np.nonzero(dg)[0].astype(np.int32), device=dev),
                             o_src=torch.as_tensor(np.nonzero(~dg)[0].astype(np.int32),
                                                   device=dev))
        self._meta = ("mpiaij", comm.nshards, blk, cb, plan.H, plan.meta(), onnz > 0)

    def _build_device_dnd_mpi(self):
        """The slab layout (aij.py:935-976), or False where it does not
        apply: the grid's slowest axis divides over the ranks, each rank
        keeps at least the stencil's reach s in planes, and the layout has
        no padding. The rank's planes carry s zero halo rows on each side."""
        out = self._grid_offsets()
        if out is None:
            return False
        uniq, inv, _ = out
        shape = self._grid_shape
        P, r = self.comm.nshards, self.comm.rank
        if shape[0] % P:
            return False
        nzl = shape[0] // P
        s = int(np.abs(uniq[:, 0]).max())
        if s > nzl or self.row_layout.pad != 0:
            return False
        K = len(uniq)
        tail = tuple(shape[1:])
        blk = self.row_layout.block
        p0, p1 = self._indptr[r * blk], self._indptr[(r + 1) * blk]
        rows = _row_of_entry(self._indptr[r * blk:(r + 1) * blk + 1]).astype(np.int64)
        coef = np.zeros((K, nzl + 2 * s) + tail)
        idx = np.unravel_index(rows, (nzl,) + tail)
        coef[(inv[p0:p1], idx[0] + s) + idx[1:]] = self._vals[p0:p1]
        cols = self._indices[p0:p1]
        hit = cols == rows + r * blk
        diag = np.bincount(rows[hit], weights=self._vals[p0:p1][hit], minlength=blk)
        dev, rd = config.device(), config.real_dtype()
        self._dev = {"coef": torch.as_tensor(coef, dtype=rd, device=dev),
                     "diag": torch.as_tensor(diag, dtype=rd, device=dev),
                     "comm": self.comm}
        if self._coo_plan is not None:
            # each of the rank's CSR entries' place in its planes, for setValuesCOO
            ext = (nzl + 2 * s,) + tail
            flat = np.ravel_multi_index((idx[0] + s,) + idx[1:], ext)
            self._dev.update(_coo_positions(rows, hit, blk, dev),
                             dnd_scatter=torch.as_tensor(inv[p0:p1] * int(np.prod(ext)) + flat,
                                                         device=dev))
        self._meta = ("dnd_mpi", P, nzl, tuple(shape),
                      tuple(tuple(int(c) for c in o) for o in uniq), s)
        return True

    @classmethod
    def from_sharded(cls, S, comm):
        """Bind a ShardedCSR (the distributed set-up's per-rank blocks) as a
        distributed MatAIJ without forming a global CSR (aij.py:1097-1117)."""
        M = cls(comm)
        rl, cl = S.row_layout, S.col_layout
        M.row_layout = Layout(rl.N, rl.nshards, axis=comm.axis)
        M.col_layout = Layout(cl.N, cl.nshards, axis=comm.axis)
        if M.row_layout.block != rl.block or M.col_layout.block != cl.block:
            raise Error(f"from_sharded: layouts {rl}, {cl} do not split as the comm's")
        per_shard = []
        for b in S.blocks:
            rows = np.repeat(np.arange(b.shape[0]), np.diff(b.indptr))
            per_shard.append((rows, b.indices.astype(np.int64), b.data))
        M._finish_build_mpi(per_shard)
        M._sharded_src = S
        M._assembled = True
        return M

    # ================= algebra on the host CSR =================

    def transpose(self):
        return MatAIJ.from_scipy(self.to_scipy().T.tocsr(), comm=self.comm)

    def duplicate(self, copy_values=True):
        A = self.to_scipy().copy()
        if not copy_values:
            A.data[:] = 0.0
        return MatAIJ.from_scipy(A, comm=self.comm)

    def scale(self, alpha):
        self._sync_host_vals()
        self._vals = self._vals * alpha
        self._refresh_device()
        self.increase_state()
        return self

    def shift(self, alpha):
        """A <- A + alpha I."""
        import scipy.sparse as sp
        m, n = self.getSize()
        A = (self.to_scipy() + alpha * sp.eye(m, n, format="csr")).tocsr()
        self.setValuesCSR(A.indptr, A.indices, A.data)
        return self.assemble()

    def axpy(self, alpha, X: "MatAIJ", structure=None):
        A = (self.to_scipy() + alpha * X.to_scipy()).tocsr()
        self.setValuesCSR(A.indptr, A.indices, A.data)
        return self.assemble()

    def diagonalScale(self, L=None, R=None):
        import scipy.sparse as sp
        A = self.to_scipy()
        if L is not None:
            A = sp.diags(np.asarray(L.getArray())) @ A
        if R is not None:
            A = A @ sp.diags(np.asarray(R.getArray()))
        A = A.tocsr()
        self.setValuesCSR(A.indptr, A.indices, A.data)
        return self.assemble()

    def zeroRows(self, rows, diag=1.0):
        """MatZeroRows: zero the rows, put `diag` on their diagonal."""
        self._sync_host_vals()
        m = self.row_layout.N
        rows = np.asarray(rows, dtype=np.int64)
        mask = np.zeros(m, dtype=bool)
        mask[rows] = True
        rr = _row_of_entry(self._indptr)
        on_diag = self._indices == rr
        keep = ~mask[rr] | on_diag
        vals = np.where(mask[rr] & on_diag, diag, self._vals)
        has_diag = np.zeros(m, dtype=bool)
        has_diag[rr[on_diag]] = True
        missing = rows[~has_diag[rows]]
        self._dedupe_sum(np.concatenate([rr[keep], missing]),
                         np.concatenate([self._indices[keep], missing]),
                         np.concatenate([vals[keep], np.full(len(missing), diag)]))
        return self.assemble()

    def zeroRowsColumns(self, rows, diag=1.0, x=None, b=None):
        """MatZeroRowsColumns: zero the rows and columns, `diag` on their
        diagonal; with x and b, move the known columns' contributions to b."""
        import scipy.sparse as sp
        rows = np.asarray(rows, dtype=np.int64)
        A = self.to_scipy().tocsr()
        if x is not None and b is not None:
            xv = np.asarray(x.getArray())[: A.shape[1]]
            mask = np.zeros(A.shape[1], dtype=bool)
            mask[rows] = True
            bv = np.asarray(b.getArray())[: A.shape[0]].copy()
            bv -= A @ (xv * mask)
            bv[rows] = diag * xv[rows]
            b.setArray(bv)
        A = A.tolil()
        for r in rows:
            A.rows[r] = [int(r)]
            A.data[r] = [diag]
        coo = A.tocsr().tocoo()
        keep = ~np.isin(coo.col, rows) | (coo.row == coo.col)
        A = sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape)
        self.setValuesCSR(A.indptr, A.indices, A.data)
        return self.assemble()

    def norm(self, norm_type=NormType.NORM_FROBENIUS):
        self._sync_host_vals()
        if norm_type == NormType.NORM_FROBENIUS:
            return float(np.linalg.norm(self._vals))
        A = self.to_scipy()
        if norm_type == NormType.NORM_1:
            return float(np.abs(A).sum(axis=0).max())
        if norm_type == NormType.NORM_INFINITY:
            return float(np.abs(A).sum(axis=1).max())
        raise ValueError(norm_type)

    def convert(self, kind):
        """MatConvert to "dense": a MatDense of the same values."""
        if kind == "dense":
            from .mat import MatDense
            return MatDense(self.comm).setSizes(self.getSize()).setDenseArray(
                self.to_scipy().toarray())
        raise ValueError(kind)

    # -------- host SpGEMM (the Galerkin setup; gamg.c RAP) --------
    # Every product runs on the host CSRs through the port's native OpenMP
    # Gustavson kernel (petsc_tpu_torch/native) and returns a new MatAIJ
    # (kind aij_csr, products on S2). A matrix whose values were set on the
    # device by setValuesCOO (the 128^3 fine operator) downloads them once
    # here, in to_scipy, per setup.

    def matMult(self, B, fill=None):
        """C = A B (MatMatMult, matrix.c:9373)."""
        return MatAIJ.from_scipy(native.spgemm(self.to_scipy(), B.to_scipy()), comm=self.comm)

    def transposeMatMult(self, B, fill=None):
        """C = A^T B (MatTransposeMatMult)."""
        At = native.csr_transpose(self.to_scipy())
        return MatAIJ.from_scipy(native.spgemm(At, B.to_scipy()), comm=self.comm)

    def ptap(self, P, fill=None):
        """C = P^T A P (MatPtAP, the Galerkin triple product; the two-product
        path of mpiptap.c:215)."""
        Ps = P.to_scipy()
        C = native.spgemm(native.csr_transpose(Ps), native.spgemm(self.to_scipy(), Ps))
        return MatAIJ.from_scipy(C, comm=self.comm)

    def rart(self, R, fill=None):
        """C = R A R^T (MatRARt)."""
        Rs = R.to_scipy()
        C = native.spgemm(Rs, native.spgemm(self.to_scipy(), native.csr_transpose(Rs)))
        return MatAIJ.from_scipy(C, comm=self.comm)

    def createSubMatrix(self, isrow, iscol=None):
        """MatCreateSubMatrix: the (isrow x iscol) block as a new MatAIJ."""
        rows = np.asarray(isrow, dtype=np.int64)
        cols = rows if iscol is None else np.asarray(iscol, dtype=np.int64)
        return MatAIJ.from_scipy(self.to_scipy()[rows][:, cols].tocsr(), comm=self.comm)


# ================= binders =================

def csr_transpose_of(data, ncols):
    """The CSR of A^T for the ``aij_csr`` data of A with ncols columns, as
    (indptr, col, vals) for S2 or M1. Its pattern (row pointers, columns,
    and each entry's position in A's values) is built once on A's device,
    at the first call, by a stable sort of A's columns; its values are one
    K8 gather of A's values, kept in ``data`` until the values change
    (``_update_device_values`` drops them on every value change)."""
    pat = data.get("csr_t")
    vals = data["vals"]
    if pat is None:
        ip, col = data["indptr"], data["col"]
        order = torch.argsort(col, stable=True)
        rows = spmv.row_ids(ip)[order]
        tptr = torch.zeros(ncols + 1, dtype=torch.int64, device=ip.device)
        tptr[1:] = torch.cumsum(torch.bincount(col.long(), minlength=ncols), 0)
        pat = data["csr_t"] = (tptr, rows.to(torch.int32), order.to(torch.int32))
    tv = data.get("csr_t_vals")
    if tv is None:
        tv = data["csr_t_vals"] = gather(vals, pat[2], check=False)
    return pat[0], pat[1], tv


def _bind_aij_csr(meta, data):
    n = meta[2]
    ip, col, vals = data["indptr"], data["col"], data["vals"]

    def mult_t(x):
        # S2 on the explicit transpose (the reference's csr_seg_spmv_t,
        # spmv.py:50, is a scatter-add; a gather product needs no atomics)
        return csr_spmv(*csr_transpose_of(data, n), x)

    return operator.Op(mult=lambda x: csr_spmv(ip, col, vals, x), mult_t=mult_t,
                       diag=lambda: data["diag"],
                       mult_mat=lambda X: csr_spmm(ip, col, vals, X))


def _bind_aij_dnd(meta, data):
    """The stencil's product: S1 for the separable constant box or star,
    V1 for every other stencil (aij.py:1292-1453)."""
    _, shape, offs = meta[:3]
    # optional per-offset CONSTANT coefficients (meta[6]); None marks a
    # variable-coefficient plane in data["coef"]
    cvals = meta[6] if len(meta) > 6 else (None,) * len(offs)
    nd = len(shape)
    center = (0,) * nd
    off_set = set(offs)
    star_set = {center} | {
        tuple(s if a == ax else 0 for a in range(nd))
        for ax in range(nd) for s in (-1, 1)}
    box_set = set(product((-1, 0, 1), repeat=nd))
    offdiag = {cvals[k] for k, o in enumerate(offs) if any(o)}
    all_const = all(c is not None for c in cvals)

    if not (all_const and center in off_set and len(offdiag) == 1
            and off_set in (box_set, star_set)):
        coef = data["coef"]
        # V1T's shifted planes are built at its first product on the card and
        # kept in data until the values change (_update_device_values drops them)
        mult_t = data.get("dnd_t")
        if mult_t is None:
            mult_t = data["dnd_t"] = dnd_stencil_t_fn(shape, offs, cvals, coef)
        return operator.Op(mult=dnd_stencil_fn(shape, offs, cvals, coef), mult_t=mult_t,
                           diag=lambda: data["diag"])
    cd = float(cvals[offs.index(center)])
    co = float(next(iter(offdiag)))
    is_box = off_set == box_set

    def mult(x):
        return const_stencil(x, shape, cd, co, is_box)

    # symmetric offset pattern + uniform coefficients: A^T = A exactly
    return operator.Op(mult=mult, mult_t=mult, diag=lambda: data["diag"])


def _bind_aij_bsr(meta, data):
    """The block layout's product on B1 (the reference's _bind_aij_bell,
    aij.py:1494-1515); the transpose runs B1 on the block transpose, built
    once at the first call and kept in data until the values change."""
    nb = meta[2] // meta[3]
    ip, bc, bv = data["bptr"], data["bcol"], data["bvals"]

    def mult_t(x):
        t = data.get("bsr_t")
        if t is None:
            t = data["bsr_t"] = bsr_transpose(data["bptr"], data["bcol"], data["bvals"], nb)
        return bsr_spmv(*t, x)

    return operator.Op(mult=lambda x: bsr_spmv(ip, bc, bv, x), mult_t=mult_t,
                       diag=lambda: data["diag"])


def _bind_mpiaij(meta, data):
    """MatMult_MPIAIJ's order (mpiaij.c:1052-1065): the halo exchange
    issued, the diagonal block's product (S2), the wait, the off-diagonal
    block's product on the halo (S2), the sum (K2); mult_t: S2 on the two
    local transposes, the halo rows' contributions sent back to their
    owners by reduce_add (X1), the sum (K2)."""
    _, P, blk, cb, H, sf_meta, has_off = meta
    d, o, plan = data["d"], data["o"], data["sf"]

    def mult(x):
        h = plan.begin(x)
        y = csr_spmv(d["indptr"], d["col"], d["vals"], x)
        halo = plan.finish(h)
        if not has_off:
            return y
        one = torch.ones((), dtype=y.dtype, device=y.device)
        return triad(y, csr_spmv(o["indptr"], o["col"], o["vals"], halo), one, out=y)

    def mult_t(x):
        yd = csr_spmv(*csr_transpose_of(d, cb), x)
        contrib = csr_spmv(*csr_transpose_of(o, H), x) if has_off else \
            torch.zeros(H, dtype=x.dtype, device=x.device)
        back = plan.reduce_add(contrib)
        one = torch.ones((), dtype=yd.dtype, device=yd.device)
        return triad(yd, back, one, out=yd)

    return operator.Op(mult=mult, mult_t=mult_t, diag=lambda: data["diag"])


def _plane_exchange(comm, low, high):
    """Send `low` (this rank's first planes) to the previous rank and `high`
    (its last planes) to the next; returns a handle whose wait() gives
    (from the previous rank, from the next), zeros at the ends."""
    P, r = comm.nshards, comm.rank
    n = low.numel()
    scnt = [0] * P
    parts = []
    if r > 0:
        scnt[r - 1] = n
        parts.append(low.reshape(-1))
    if r < P - 1:
        scnt[r + 1] = n
        parts.append(high.reshape(-1))
    send = torch.cat(parts) if parts else low.reshape(-1)[:0]
    h = comm.alltoallv_start(send, scnt, scnt)

    def wait():
        recv = h.wait()
        z = torch.zeros(n, dtype=low.dtype, device=low.device)
        prev = recv[:n] if r > 0 else z
        nxt = recv[n * (r > 0):] if r < P - 1 else z
        return prev, nxt

    return wait


def _bind_dnd_mpi(meta, data):
    """The slab stencil (aij.py:1589-1672) on V1 and V1T over the slab's
    buffer with s halo planes a side."""
    _, P, nzl, shape, offs, s = meta
    comm, coef = data["comm"], data["coef"]
    tail = tuple(shape[1:])
    plane = int(np.prod(tail)) if tail else 1
    ext = (nzl + 2 * s,) + tail
    consts = (None,) * len(offs)
    v1 = dnd_stencil_fn(ext, offs, consts, coef)
    lo, hi = s * plane, (s + nzl) * plane

    def mult(x):
        buf = torch.empty(ext[0] * plane, dtype=x.dtype, device=x.device)
        if s:
            wait = _plane_exchange(comm, x[:lo], x[-lo:])
        buf[lo:hi] = x
        if s:
            prev, nxt = wait()
            buf[:lo] = prev
            buf[hi:] = nxt
        return v1(buf)[lo:hi]

    def mult_t(x):
        v1t = data.get("dnd_t")
        if v1t is None:
            v1t = data["dnd_t"] = dnd_stencil_t_fn(ext, offs, consts, coef)
        buf = torch.zeros(ext[0] * plane, dtype=x.dtype, device=x.device)
        buf[lo:hi] = x
        y = v1t(buf)
        core = y[lo:hi].clone()
        if s:
            prev, nxt = _plane_exchange(comm, y[:lo].contiguous(), y[hi:].contiguous())()
            one = torch.ones((), dtype=x.dtype, device=x.device)
            # the reference adds the next rank's low rows first, then the
            # previous rank's high rows (aij.py:1661-1662)
            top = core[nzl * plane - lo:]
            triad(top, nxt, one, out=top)
            bot = core[:lo]
            triad(bot, prev, one, out=bot)
        return core

    return operator.Op(mult=mult, mult_t=mult_t, diag=lambda: data["diag"])


operator.register_binder("aij_csr", _bind_aij_csr)
operator.register_binder("mpiaij", _bind_mpiaij)
operator.register_binder("dnd_mpi", _bind_dnd_mpi)
operator.register_binder("aij_bsr", _bind_aij_bsr)
operator.register_binder("aij_dnd", _bind_aij_dnd)
