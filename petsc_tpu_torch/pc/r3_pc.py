"""PCQR, PCSPAI and PCNN.

Counterpart of ``petsc_tpu/pc/r3_pc.py``:

* qr (factor/qr): a dense column-pivoted QR on the host, truncated where
  R's diagonal is numerically zero (the pseudo-inverse on a singular
  operator); the apply's small dense work (Q^T b and the triangular solve)
  stays in library torch (ROADMAP queue 2 item 7), the scatter by the
  pivots is X1.
* spai (spai.c role): the static-pattern sparse approximate inverse,
  minimising ||A M - I||_F column by column in batches by pattern size on
  the host (the reference's code); the apply is M as a MatAIJ (S2).
* nn (is/nn): two-level additive Neumann-Neumann on a MatIS: the
  multiplicity-scaled local pseudo-inverses on D1, their scatter-add on
  X1, the coarse restriction W r on D1 (a row of ones per subdomain: each
  subdomain's sum of its scaled dofs), the interpolation W^T c on X1, the
  coarse solve ``torch.mv``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import operator, pc_kernels
from ..ops.pallas_kernels import triad
from ..sys.error import Error
from .pc import PC


class _PCQR:
    """Direct solve through a dense column-pivoted QR (the reference's
    factor/qr role): rank-deficient columns are truncated."""

    def __init__(self, pc):
        self.pc = pc

    def set_from_options(self):
        pass

    def setup(self):
        import scipy.linalg as sla
        A = self.pc.pmat.to_scipy().toarray() if hasattr(self.pc.pmat, "to_scipy") \
            else self.pc.pmat.getDenseArray()
        n = A.shape[0]
        Q, R, piv = sla.qr(A, mode="economic", pivoting=True)
        d = np.abs(np.diag(R))
        tol = max(A.shape) * np.finfo(float).eps * (d.max() if len(d) else 1)
        rank = int((d > tol).sum())
        rd, dev = config.real_dtype(), config.device()
        data = {"Qt": torch.as_tensor(np.ascontiguousarray(Q[:, :rank].T), dtype=rd, device=dev),
                "R": torch.as_tensor(R[:rank, :rank], dtype=rd, device=dev),
                "piv": pc_kernels.scatter_table(piv[:rank], np.arange(rank), n, rank,
                                                device=dev, dtype=rd)}
        return ("pc_qr", n, rank), data


def _bind_qr(meta, data):
    def mult(b):
        y = torch.mv(data["Qt"], b)
        z = torch.linalg.solve_triangular(data["R"], y.unsqueeze(1), upper=True).squeeze(1)
        return pc_kernels.dst_scatter(data["piv"], z.contiguous())

    return operator.Op(mult=mult)


operator.register_binder("pc_qr", _bind_qr)
PC.register_impl("qr", _PCQR)


class _PCSPAI:
    """Static-pattern sparse approximate inverse (spai.c role): M with
    the sparsity of A (or of A^2 with -pc_spai_pattern power2) minimizing
    ||A M - I||_F column by column — each column is an independent small
    dense least-squares, solved here batched by pattern size (the same
    batching trick as GAMG's per-aggregate QR). The reference's SPAI
    package grows the pattern adaptively (eps/nbsteps); the static
    variant is the classic Grote-Huckle starting point and is documented
    as such. Apply = one SpMV with M (explicitly assembled, so it rides
    whatever device layout MatAIJ picks)."""

    def __init__(self, pc):
        self.pc = pc
        self.pattern = "same"

    def set_from_options(self):
        t = self.pc.opt("get_string", "pc_spai_pattern", None)
        if t:
            self.pattern = t

    def setup(self):
        import scipy.sparse as sp
        from ..mat.aij import MatAIJ
        A = self.pc.pmat.to_scipy().tocsr()
        n = A.shape[0]
        Pat = A
        if self.pattern in ("power2", "ata"):
            B = A.copy()
            B.data = np.ones_like(B.data)
            Pat = (B @ B).tocsr()
        Ac = A.tocsc()
        Pc = Pat.tocsc()
        rows_l, cols_l, vals_l = [], [], []
        # group columns by pattern size; each group is ONE batched
        # minimum-norm solve (stacked pinv == per-column lstsq: zero
        # rows padded onto a least-squares system change nothing)
        sizes = np.diff(Pc.indptr)
        for sz in np.unique(sizes):
            if sz == 0:
                continue
            cols = np.nonzero(sizes == sz)[0]
            J = Pc.indices[Pc.indptr[cols][:, None] + np.arange(sz)]
            for c0 in range(0, len(cols), 4096):
                cc, JJ = cols[c0:c0 + 4096], J[c0:c0 + 4096]
                r, c, v = self._solve_group(Ac, cc, JJ)
                rows_l.append(r); cols_l.append(c); vals_l.append(v)
        M = sp.csr_matrix((np.concatenate(vals_l),
                           (np.concatenate(rows_l), np.concatenate(cols_l))),
                          shape=(n, n))
        Mm = MatAIJ.from_scipy(M, comm=self.pc.pmat.comm)
        return Mm.meta, Mm.device_data()

    @staticmethod
    def _solve_group(Ac, cols, J):
        """min ||A[:, J_b] m_b - e_{cols[b]}|| for a batch of columns with
        one pattern size, fully vectorized: CSC entries of every A[:, J_b]
        are expanded flat, per-batch touched-row sets deduplicated with a
        lexsort, the dense (B, mi_max, sz) local systems scatter-built,
        and all B minimum-norm solutions come from one stacked pinv."""
        B, sz = J.shape
        st, en = Ac.indptr[J], Ac.indptr[J + 1]
        cnt = (en - st).ravel()                       # entries per (b,slot)
        tot = int(cnt.sum())
        if tot == 0:
            return (J.ravel(), np.repeat(cols, sz),
                    np.zeros(B * sz))
        flat_id = np.repeat(np.arange(B * sz), cnt)
        base = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        pos = np.arange(tot) - np.repeat(base, cnt) + np.repeat(st.ravel(), cnt)
        rows_e, vals_e = Ac.indices[pos], Ac.data[pos]
        bid, slot = flat_id // sz, flat_id % sz
        # per-batch unique touched rows -> local row index
        order = np.lexsort((rows_e, bid))
        bs_, rs_ = bid[order], rows_e[order]
        newrow = np.empty(tot, bool)
        newrow[0] = True
        newrow[1:] = (bs_[1:] != bs_[:-1]) | (rs_[1:] != rs_[:-1])
        uid = np.cumsum(newrow) - 1                   # global unique id
        ub, ur = bs_[newrow], rs_[newrow]             # (nuniq,) owners/rows
        first_uid_of_b = np.searchsorted(ub, np.arange(B))
        lrow_sorted = uid - first_uid_of_b[bs_]
        lrow = np.empty(tot, dtype=np.int64)
        lrow[order] = lrow_sorted
        mi = np.diff(np.append(first_uid_of_b, len(ub)))  # rows per batch
        mi_max = int(mi.max())
        lhs = np.zeros((B, mi_max, sz))
        lhs[bid, lrow, slot] = vals_e
        rhs = np.zeros((B, mi_max))
        hit = ur == cols[ub]                          # unit-vector rows
        rhs[ub[hit], (np.arange(len(ub)) - first_uid_of_b[ub])[hit]] = 1.0
        m = np.einsum("bsm,bm->bs", np.linalg.pinv(lhs), rhs)
        return J.ravel(), np.repeat(cols, sz), m.ravel()


PC.register_impl("spai", _PCSPAI)


def nn_tables(M):
    """PCNN's set-up on the host (the reference's r3_pc.py:214-238): the
    local pseudo-inverses D_i K_i^+ D_i's pieces padded (ns, nl, nl), the
    multiplicity scaling D, and the coarse space W of the scaled subdomain
    constants."""
    mats, maps = M.getLocalMats()
    ns = len(mats)
    mult = M.interface_multiplicity()
    ks = np.asarray([len(g) for g in maps], dtype=np.int64)
    nl = int(ks.max())
    G = np.zeros((ns, nl), dtype=np.int64)
    D = np.zeros((ns, nl))
    Kinv = np.zeros((ns, nl, nl))
    for s, (Ai, gi) in enumerate(zip(mats, maps)):
        K = Ai.toarray() if hasattr(Ai, "toarray") else np.asarray(Ai)
        gi = np.asarray(gi, dtype=np.int64)
        k = len(gi)
        G[s, :k] = gi
        D[s, :k] = 1.0 / mult[gi]
        Kinv[s, :k, :k] = np.linalg.pinv(K)
    return ns, nl, ks, G, D, Kinv


class _PCNN:
    """PCNN (is/nn): two-level additive Neumann-Neumann on MATIS,

        M^-1 = sum_i R_i^T D_i K_i^+ D_i R_i  +  W Kc^-1 W^T,

    K_i the local Neumann matrices (their pseudo-inverses), D_i = 1 /
    multiplicity, W the multiplicity-scaled subdomain constants and
    Kc = W A W^T (the additive form the reference implements)."""

    def __init__(self, pc):
        self.pc = pc

    def set_from_options(self):
        pass

    def setup(self):
        from ..mat.utility import MatIS
        M = self.pc.pmat
        if not isinstance(M, MatIS):
            raise Error("PCNN requires a MATIS operator "
                        "(MatIS.create with local Neumann matrices)")
        ns, nl, ks, G, D, Kinv = nn_tables(M)
        npad = M.row_layout.Npad
        valid = np.arange(nl)[None, :] < ks[:, None]
        rd, dev = config.real_dtype(), config.device()
        flat = np.flatnonzero(valid)
        sidx = np.repeat(np.arange(ns), ks)
        data = {"Kinv": torch.as_tensor(Kinv, dtype=rd, device=dev),
                "local": pc_kernels.subdomain_table(G, D, nr=ks, nc=ks, device=dev, dtype=rd),
                # y += D zl by global row; rc = W r (ones times the scaled
                # gather); W^T c by global row
                "back": pc_kernels.scatter_table(G[valid], flat, npad, ns * nl, D[valid],
                                                 device=dev, dtype=rd),
                "ones": torch.ones((ns, 1, nl), dtype=rd, device=dev),
                "coarse_r": pc_kernels.subdomain_table(G, D, nr=np.ones(ns), nc=ks, device=dev,
                                                       dtype=rd),
                "coarse_i": pc_kernels.scatter_table(G[valid], sidx, npad, ns, D[valid],
                                                     device=dev, dtype=rd)}
        # the coarse operator Kc = W A W^T through the MATIS action, one
        # product per subdomain's column of W (on the device), then the host
        Aop = M.op()
        Wm = np.zeros((ns, npad))
        for s in range(ns):
            Wm[s, G[s, :ks[s]]] += D[s, :ks[s]]
        Wt = torch.as_tensor(Wm, dtype=rd, device=dev)
        AW = torch.stack([Aop.mult(Wt[s].contiguous()) for s in range(ns)]).cpu().double().numpy()
        Kc = Wm @ AW.T
        data["Kc_inv"] = torch.as_tensor(np.linalg.pinv(Kc), dtype=rd, device=dev)
        return ("pc_nn", ns, nl, npad), data


def _bind_nn(meta, data):
    def mult(r):
        zl = pc_kernels.subdomain_apply(data["Kinv"], data["local"], r)
        y = pc_kernels.dst_scatter(data["back"], zl.view(-1))
        rc = pc_kernels.subdomain_apply(data["ones"], data["coarse_r"], r).view(-1)
        c = torch.mv(data["Kc_inv"], rc)
        return triad(y, pc_kernels.dst_scatter(data["coarse_i"], c),
                     torch.ones((), dtype=r.dtype, device=r.device))

    return operator.Op(mult=mult)


operator.register_binder("pc_nn", _bind_nn)
PC.register_impl("nn", _PCNN)
