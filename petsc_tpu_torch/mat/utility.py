"""The wrapper matrices: implicit transpose, normal (A^T A), diagonal,
composite (sum or product), low-rank correction, centering, nest, Schur
complement, MAIJ, the preallocator, MATIS and the local reference.

Counterpart of ``petsc_tpu/mat/utility.py`` (reference src/mat/impls/
{transpose, normal, diagonal, composite, lrc, nest, cdbdm, maij,
preallocator, is, localref} and src/ksp/ksp/utils/schurm). Each is an Op
over the wrapped operators' (meta, data), as in the reference. Two differ
in how they run on the card:
* MatMAIJ (I_dof (x) A in node-major order) applies an ``aij_csr`` A to
  all dof components at once with the hand kernel M1
  (:func:`ops.pallas_kernels.csr_spmm`), which reads A once where the
  reference vmaps the CSR product over the components; its transpose is
  M1 on A's explicit transpose (:func:`.aij.csr_transpose_of`). Any other
  A is applied component by component through its own binder.
* MatSchurComplement's inner solve is the port's KSP loop (one solve per
  product), where the reference nests a compiled Krylov loop.
* MATIS's apply on the card is the hand kernels D1 (the batched local
  products on the padded tables, :func:`ops.pc_kernels.subdomain_apply`)
  and X1 (the scatter-add by destination, no atomics,
  :func:`ops.pc_kernels.dst_scatter`); the gather, ``einsum`` and
  ``index_add_`` stay as its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import operator
from ..ops import pc_kernels
from ..ops.pallas_kernels import csr_spmm
from ..sys.error import Error
from ..vec.vec import InsertMode, Vec
from .mat import Mat


def _tensor(a):
    """An array or Vec as a tensor of the real dtype on the port's device."""
    if isinstance(a, Vec):
        return a.array
    return torch.as_tensor(np.asarray(a), dtype=config.real_dtype(), device=config.device())


class _WrapperMat(Mat):
    """Common plumbing: subclasses set _meta_v and _data_v at create time."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._meta_v = None
        self._data_v = None
        self._assembled = True

    @property
    def meta(self):
        return self._meta_v

    def device_data(self):
        return self._data_v


class MatTranspose(_WrapperMat):
    """A^T without forming it (MatCreateTranspose)."""

    @classmethod
    def create(cls, A, comm=None):
        M = cls(comm or A.comm)
        m, n = A.getSize()
        M.setSizes((n, m))
        M._meta_v = ("mat_transpose", A.meta)
        M._data_v = {"A": A.device_data()}
        return M


def _bind_transpose(meta, data):
    inner = operator.bind(meta[1], data["A"])
    if inner.mult_t is None:
        raise Error("MatTranspose: wrapped operator has no mult_t")
    return operator.Op(mult=inner.mult_t, mult_t=inner.mult)


class MatNormal(_WrapperMat):
    """A^T A (MatCreateNormal, normm.c): the least-squares operator."""

    @classmethod
    def create(cls, A, comm=None):
        M = cls(comm or A.comm)
        n = A.getSize()[1]
        M.setSizes((n, n))
        M._meta_v = ("mat_normal", A.meta)
        M._data_v = {"A": A.device_data()}
        return M


def _bind_normal(meta, data):
    inner = operator.bind(meta[1], data["A"])

    def mult(x):
        return inner.mult_t(inner.mult(x))

    return operator.Op(mult=mult, mult_t=mult)


class MatDiagonal(_WrapperMat):
    """diag(d) (MatCreateDiagonal)."""

    @classmethod
    def create(cls, d, comm=None):
        arr = _tensor(d)
        M = cls(comm)
        M.setSizes((arr.shape[0], arr.shape[0]))
        M._meta_v = ("mat_diagonal", int(arr.shape[0]))
        M._data_v = {"d": arr}
        return M


def _bind_diagonal(meta, data):
    d = data["d"]
    return operator.Op(mult=lambda x: d * x, mult_t=lambda x: d * x, diag=lambda: d)


class MatComposite(_WrapperMat):
    """A sum or product of matrices (MatCreateComposite; composite.c).
    additive: y = (A_1 + ... + A_k) x; multiplicative: y = A_k ... A_1 x."""

    @classmethod
    def create(cls, mats, ctype="additive", comm=None):
        M = cls(comm or mats[0].comm)
        M.setSizes(mats[0].getSize() if ctype == "additive"
                   else (mats[-1].getSize()[0], mats[0].getSize()[1]))
        M._meta_v = ("mat_composite", ctype, tuple(A.meta for A in mats))
        M._data_v = {"mats": tuple(A.device_data() for A in mats)}
        return M


def _bind_composite(meta, data):
    _, ctype, metas = meta
    ops = [operator.bind(mi, di) for mi, di in zip(metas, data["mats"])]

    def mult(x):
        if ctype == "additive":
            y = ops[0].mult(x)
            for o in ops[1:]:
                y = y + o.mult(x)
            return y
        y = x
        for o in ops:
            y = o.mult(y)
        return y

    return operator.Op(mult=mult)


class MatLRC(_WrapperMat):
    """A low-rank correction A + U C V^T (MatCreateLRC, lrc.c): U and V
    dense (n, k), C dense (k, k) or None for the identity, A None for 0."""

    @classmethod
    def create(cls, A, U, C=None, V=None, comm=None):
        M = cls(comm or (A.comm if A is not None else None))
        Ut = _tensor(U)
        Vt = Ut if V is None else _tensor(V)
        n = Ut.shape[0]
        M.setSizes((n, n))
        M._meta_v = ("mat_lrc", None if A is None else A.meta, C is None)
        M._data_v = {"A": None if A is None else A.device_data(), "U": Ut, "V": Vt,
                     "C": None if C is None else _tensor(C)}
        return M


def _bind_lrc(meta, data):
    _, ameta, c_is_id = meta
    U, V, C = data["U"], data["V"], data["C"]
    inner = None if ameta is None else operator.bind(ameta, data["A"])

    def mult(x):
        t = V.T @ x
        if not c_is_id:
            t = C @ t
        y = U @ t
        if inner is not None:
            y = y + inner.mult(x)
        return y

    return operator.Op(mult=mult)


class MatCentering(_WrapperMat):
    """I - (1/n) 1 1^T (MatCreateCentering)."""

    @classmethod
    def create(cls, n, comm=None):
        M = cls(comm)
        M.setSizes((n, n))
        M._meta_v = ("mat_centering", int(n))
        M._data_v = {}
        return M


def _bind_centering(meta, data):
    n = meta[1]

    def mult(x):
        return x - torch.mean(x[:n])

    return operator.Op(mult=mult, mult_t=mult)


class MatNest(_WrapperMat):
    """A block matrix of sub-matrices (MatCreateNest; impls/nest). Blocks may
    be None (zero). Vectors are the concatenation of the row and column
    segments, at the offsets of the blocks' sizes (one device: no padding)."""

    @classmethod
    def create(cls, blocks, comm=None):
        nr, nc = len(blocks), len(blocks[0])
        row_sizes, col_sizes = [None] * nr, [None] * nc
        for i in range(nr):
            for j in range(nc):
                if blocks[i][j] is not None:
                    row_sizes[i], col_sizes[j] = blocks[i][j].getSize()
        if any(s is None for s in row_sizes + col_sizes):
            raise Error("MatNest: every row/col needs at least one block")
        comm = comm or next(b.comm for r in blocks for b in r if b is not None)
        M = cls(comm)
        M.setSizes((sum(row_sizes), sum(col_sizes)))
        M._row_sizes, M._col_sizes = row_sizes, col_sizes
        M._meta_v = ("mat_nest", tuple(row_sizes), tuple(col_sizes),
                     tuple(tuple(None if b is None else b.meta for b in r) for r in blocks))
        M._data_v = {"blocks": tuple(tuple(None if b is None else b.device_data() for b in r)
                                     for r in blocks)}
        return M


def _bind_nest(meta, data):
    _, row_sizes, col_sizes, metas = meta
    coff = np.concatenate([[0], np.cumsum(col_sizes)]).tolist()
    ops = [[None if metas[i][j] is None else operator.bind(metas[i][j], data["blocks"][i][j])
            for j in range(len(col_sizes))] for i in range(len(row_sizes))]

    def mult(x):
        segs = []
        for i in range(len(row_sizes)):
            yi = torch.zeros(row_sizes[i], dtype=x.dtype, device=x.device)
            for j in range(len(col_sizes)):
                if ops[i][j] is not None:
                    yi = yi + ops[i][j].mult(x[coff[j]:coff[j + 1]])
            segs.append(yi)
        return torch.cat(segs)

    return operator.Op(mult=mult)


operator.register_binder("mat_transpose", _bind_transpose)
operator.register_binder("mat_normal", _bind_normal)
operator.register_binder("mat_diagonal", _bind_diagonal)
operator.register_binder("mat_composite", _bind_composite)
operator.register_binder("mat_lrc", _bind_lrc)
operator.register_binder("mat_centering", _bind_centering)
operator.register_binder("mat_nest", _bind_nest)


class MatSchurComplement(_WrapperMat):
    """S = A11 - A10 inv(A00) A01 applied implicitly (MatCreateSchur-
    Complement, src/ksp/ksp/utils/schurm/schurm.c). Each product runs one
    inner solve with A00 from a zero guess through the port's KSP loop.
    ``getKSP()`` gives the inner solver (MatSchurComplementGetKSP) to
    configure before the first use: the operator is built lazily, once,
    with the solver as it stands then (a solver left without a type takes
    the options database's)."""

    @classmethod
    def create(cls, A00, A01, A10, A11=None, comm=None, ksp=None):
        M = cls(comm or A00.comm)
        M.setSizes((A10.getSize()[0], A01.getSize()[1]))
        M._blocks = (A00, A01, A10, A11)
        M._ksp = ksp
        return M

    def getKSP(self):
        if self._ksp is None:
            from ..ksp.ksp import KSP
            self._ksp = KSP().create()
            self._ksp.setOperators(self._blocks[0])
        return self._ksp

    def getSubMatrices(self):
        return self._blocks

    def _build(self):
        if self._meta_v is not None:
            return
        A00, A01, A10, A11 = self._blocks
        ksp = self.getKSP()
        if ksp._type is None:
            ksp.setFromOptions()
        ksp.setUp()
        cfg = ksp._static_cfg()
        self._meta_v = ("mat_schur", ksp._type, A00.meta, ksp.pc.meta, cfg, float(ksp.rtol),
                        float(ksp.abstol), float(ksp.divtol), A01.meta, A10.meta,
                        None if A11 is None else A11.meta)
        self._data_v = {"A00": A00.device_data(), "B00": ksp.pc.device_data(),
                        "A01": A01.device_data(), "A10": A10.device_data(),
                        "A11": None if A11 is None else A11.device_data()}

    @property
    def meta(self):
        self._build()
        return self._meta_v

    def device_data(self):
        self._build()
        return self._data_v


def _bind_mat_schur(meta, data):
    from ..ksp.ksp import _IMPLS
    _, ktype, m00, mpc, cfg, rtol, abstol, divtol, m01, m10, m11 = meta
    fn = _IMPLS[ktype]["fn"]
    A00 = operator.bind(m00, data["A00"])
    B00 = operator.bind(mpc, data["B00"])
    A01 = operator.bind(m01, data["A01"])
    A10 = operator.bind(m10, data["A10"])
    A11 = None if m11 is None else operator.bind(m11, data["A11"])

    def mult(x):
        w = A01.mult(x)
        res = fn(A00, B00, w, torch.zeros_like(w), rtol, abstol, divtol, cfg)
        y = -A10.mult(res.x)
        if A11 is not None:
            y = y + A11.mult(x)
        return y

    return operator.Op(mult=mult)


operator.register_binder("mat_schur", _bind_mat_schur)


class MatMAIJ(_WrapperMat):
    """I_dof (x) A in interlaced (node-major) order: y[i*d + c] = sum_j
    A[i, j] x[j*d + c] (MatCreateMAIJ, impls/maij: the multi-component
    wrapper PCMG uses for dof > 1 fields). With an ``aij_csr`` A the
    product is one launch of M1 over the (n, dof) block."""

    @classmethod
    def create(cls, A, dof, comm=None):
        M = cls(comm or A.comm)
        m, n = A.getSize()
        M.dof = int(dof)
        M.setSizes((m * M.dof, n * M.dof))
        M._meta_v = ("mat_maij", A.meta, M.dof, n)
        M._data_v = {"A": A.device_data()}
        M._base = A
        return M

    def getAIJ(self):
        return self._base


def block_product(ameta, adata, transpose=False):
    """X -> A X (or A^T X) for an (n, k) row-major block X: one launch of
    M1 when A is ``aij_csr`` (its transpose on A's explicit transpose),
    else A's own product on each column."""
    if ameta[0] == "aij_csr":
        from .aij import csr_transpose_of

        def prod(X):
            ip, col, vals = csr_transpose_of(adata, ameta[2]) if transpose else \
                (adata["indptr"], adata["col"], adata["vals"])
            return csr_spmm(ip, col, vals, X.contiguous())

        return prod
    op = operator.bind(ameta, adata)
    fn = op.mult_t if transpose else op.mult
    if fn is None:
        raise Error(f"operator kind '{ameta[0]}' has no transpose product")

    def per_column(X):
        return torch.stack([fn(X[:, c].contiguous()) for c in range(X.shape[1])], dim=1)

    return per_column


def _bind_mat_maij(meta, data):
    _, ameta, dof, n = meta
    prod = block_product(ameta, data["A"])
    prod_t = block_product(ameta, data["A"], transpose=True)

    def mult(x):
        return prod(x[: n * dof].reshape(n, dof)).reshape(-1)

    def mult_t(x):
        # a length that is not a multiple of dof is truncated, as the
        # reference does (utility.py:366-370)
        return prod_t(x[: (x.shape[0] // dof) * dof].reshape(-1, dof)).reshape(-1)

    return operator.Op(mult=mult, mult_t=mult_t)


operator.register_binder("mat_maij", _bind_mat_maij)


class MatPreallocator(_WrapperMat):
    """MATPREALLOCATOR (impls/preallocator): records the pattern that
    setValues stages, so that code written for the reference's two-pass
    idiom runs unchanged; ``preallocate(B)`` gives the pattern to B."""

    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self._rows: list = []
        self._cols: list = []

    @classmethod
    def create(cls, size, comm=None):
        M = cls(comm)
        M.setSizes((size, size) if np.isscalar(size) else size)
        return M

    def setValues(self, rows, cols, values=None, addv=None):
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        self._rows.append(np.repeat(rows, len(cols)))
        self._cols.append(np.tile(cols, len(rows)))

    def assemble(self, *a):
        return self

    def assemblyBegin(self, *a):
        pass

    def assemblyEnd(self, *a):
        pass

    def preallocate(self, B, fill_zero=True):
        """MatPreallocatorPreallocate: the recorded pattern into B, as zeros."""
        import scipy.sparse as sp
        r = np.concatenate(self._rows) if self._rows else np.zeros(0, np.int64)
        c = np.concatenate(self._cols) if self._cols else np.zeros(0, np.int64)
        S = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=self.getSize())
        S.sum_duplicates()
        B.setValuesCSR(S.indptr, S.indices, np.zeros(S.nnz))
        B.assemble()
        return B


class MatIS(_WrapperMat):
    """MATIS (impls/is/matis.c): the unassembled domain-decomposition
    format A = sum_i R_i^T A_i R_i. The subdomain matrices are padded to
    one size and stacked dense (nsub, nl, nl), as the reference lays them
    out; the apply is D1 (each subdomain's product on its own rows and
    columns, into an (nsub, nl) local buffer) and X1 (the scatter-add of the
    local buffer by global row). The tables of both are built here, once."""

    @classmethod
    def create(cls, size, local_mats, l2g_maps, comm=None):
        M = cls(comm)
        M.setSizes((size, size) if np.isscalar(size) else size)
        nsub = len(local_mats)
        ks = np.asarray([len(g) for g in l2g_maps], dtype=np.int64)
        nl = int(ks.max())
        Ab = np.zeros((nsub, nl, nl))
        G = np.zeros((nsub, nl), dtype=np.int64)
        for i, (Ai, gi) in enumerate(zip(local_mats, l2g_maps)):
            Ai = Ai.toarray() if hasattr(Ai, "toarray") else np.asarray(Ai)
            k = len(gi)
            Ab[i, :k, :k] = Ai
            G[i, :k] = np.asarray(gi, dtype=np.int64)
        valid = np.arange(nl)[None, :] < ks[:, None]
        dev, rd = config.device(), config.real_dtype()
        M._meta_v = ("mat_is", nsub, nl, M.row_layout.Npad)
        M._data_v = {"Ab": _tensor(Ab), "G": torch.as_tensor(G, device=dev),
                     "valid": _tensor(valid.astype(np.float64)),
                     "d1": pc_kernels.subdomain_table(G, nr=ks, nc=ks, device=dev, dtype=rd),
                     "x1": pc_kernels.scatter_table(G[valid], np.flatnonzero(valid),
                                                    M.row_layout.Npad, nsub * nl,
                                                    device=dev, dtype=rd)}
        M._locals = (local_mats, l2g_maps)
        return M

    def getLocalMats(self):
        return self._locals

    def assemble_global(self):
        """MatISGetMPIXAIJ: the sum as an assembled MatAIJ."""
        import scipy.sparse as sp
        from .aij import MatAIJ
        rows, cols, vals = [], [], []
        for Ai, gi in zip(*self._locals):
            Ai = sp.coo_matrix(Ai)
            gi = np.asarray(gi)
            rows.append(gi[Ai.row])
            cols.append(gi[Ai.col])
            vals.append(Ai.data)
        S = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                          shape=self.getSize())
        S.sum_duplicates()
        return MatAIJ.from_scipy(S, comm=self.comm)

    def interface_multiplicity(self):
        """How many subdomains touch each global dof (BDDC's D_i scaling)."""
        cnt = np.zeros(self.getSize()[0])
        for gi in self._locals[1]:
            cnt[np.asarray(gi)] += 1.0
        return cnt


def mat_is_plain(data, x):
    """The reference's apply: gather, batched product, scatter-add."""
    Ab, G, valid = data["Ab"], data["G"], data["valid"]
    xl = x[G] * valid
    yl = torch.einsum("sij,sj->si", Ab, xl)
    y = torch.zeros(data["x1"].n, dtype=x.dtype, device=x.device)
    return y.index_add_(0, G.reshape(-1), (yl * valid).reshape(-1))


def _bind_mat_is(meta, data):
    def mult(x):
        if x.device.type == "cpu":
            return mat_is_plain(data, x)
        yl = pc_kernels.subdomain_apply(data["Ab"], data["d1"], x)
        return pc_kernels.dst_scatter(data["x1"], yl.view(-1))

    return operator.Op(mult=mult)


operator.register_binder("mat_is", _bind_mat_is)


class MatLocalRef(_WrapperMat):
    """MatCreateLocalRef (impls/localref): a window onto a parent matrix
    through row and column index sets. setValues through the window land
    in the parent; its own apply is the parent's submatrix."""

    @classmethod
    def create(cls, parent, isrow, iscol=None):
        M = cls(parent.comm)
        M._parent = parent
        M._ir = np.asarray(isrow, dtype=np.int64)
        M._ic = M._ir if iscol is None else np.asarray(iscol, dtype=np.int64)
        M.setSizes((len(M._ir), len(M._ic)))
        M._sub = None
        return M

    def setValues(self, rows, cols, values, addv=None):
        rows = self._ir[np.atleast_1d(np.asarray(rows, dtype=np.int64))]
        cols = self._ic[np.atleast_1d(np.asarray(cols, dtype=np.int64))]
        self._parent.setValues(rows, cols, values,
                               addv if addv is not None else InsertMode.INSERT_VALUES)
        return self

    def assemble(self, *a):
        return self._parent.assemble()

    def assemblyBegin(self, *a):
        pass

    def assemblyEnd(self, *a):
        return self.assemble()

    def _submatrix(self):
        self._sub = self._parent.createSubMatrix(self._ir, self._ic)
        return self._sub

    @property
    def meta(self):
        return self._submatrix().meta

    def device_data(self):
        return (self._sub or self._submatrix()).device_data()


__all__ = ["MatTranspose", "MatNormal", "MatDiagonal", "MatComposite", "MatLRC",
           "MatCentering", "MatNest", "MatSchurComplement", "MatMAIJ", "MatPreallocator",
           "MatIS", "MatLocalRef"]
