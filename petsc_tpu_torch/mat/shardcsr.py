"""ShardedCSR: the per-rank row-block form of a matrix for distributed set-up.

Counterpart of ``petsc_tpu/mat/shardcsr.py`` (the host side of MATMPIAIJ
for set-up algorithms: mpiptap.c's scalable PtAP, mpiov.c's overlap,
mpimatmatmult.c), all of it host numpy as in the reference: the matrix
exists as per-rank row blocks (scipy CSR with global column indices, each
block the rank's padded ownership range), and every cross-rank motion is
an explicit row fetch keyed by owner, the structure of an SF exchange.
Every rank of the port runs these same operations on the same blocks
(host set-up runs the same on every rank), so each holds the result of
every rank and the tables equal the reference's by construction.

Column indices live in the padded global space (owner = idx // block);
ragged per-rank counts (aggregates per rank) are in-block gaps: empty
rows and zero vector entries.
"""

from __future__ import annotations

import numpy as np

from ..parallel.layout import Layout


def _empty_csr(m, n):
    import scipy.sparse as sp
    return sp.csr_matrix((m, n))


class ShardedCSR:
    def __init__(self, blocks, row_layout: Layout, col_layout: Layout):
        """blocks[s]: scipy CSR with row_layout.block rows (padded; gap/pad
        rows empty) and col_layout.Npad columns (global padded space)."""
        import scipy.sparse as sp
        self.row_layout = row_layout
        self.col_layout = col_layout
        self.blocks = [b.tocsr() for b in blocks]
        for b in self.blocks:
            assert b.shape == (row_layout.block, col_layout.Npad), \
                (b.shape, row_layout.block, col_layout.Npad)

    # ---------------- construction ----------------

    @classmethod
    def from_global_csr(cls, A, nshards, col_layout=None):
        """Split an existing global CSR (testing / small sizes)."""
        rl = Layout(A.shape[0], nshards=nshards)
        cl = col_layout or Layout(A.shape[1], nshards=nshards)
        import scipy.sparse as sp
        if A.shape[1] != cl.Npad:
            A = sp.csr_matrix(
                sp.hstack([A, sp.csr_matrix((A.shape[0],
                                             cl.Npad - A.shape[1]))]))
        blocks = []
        for s in range(nshards):
            lo, hi = rl.range(s)
            b = A[lo:hi]
            if b.shape[0] < rl.block:
                b = sp.vstack([b, _empty_csr(rl.block - b.shape[0],
                                             cl.Npad)]).tocsr()
            blocks.append(b)
        return cls(blocks, rl, cl)

    def to_global_csr(self):
        """Collapse to one CSR (ONLY for small/replicated tails)."""
        import scipy.sparse as sp
        return sp.vstack(self.blocks).tocsr()[: self.row_layout.N,
                                              : self.col_layout.Npad]

    @property
    def nshards(self):
        return self.row_layout.nshards

    def nnz(self):
        return sum(int(b.nnz) for b in self.blocks)

    # ---------------- exchange primitive ----------------

    def fetch_rows(self, global_rows):
        """Return a CSR of the requested GLOBAL (padded-space) rows,
        assembled owner-by-owner — the SF-bcast of matrix rows
        (MatCreateSubMatrices / mpiov.c role). global_rows: sorted unique
        int array."""
        import scipy.sparse as sp
        rl = self.row_layout
        owners = rl.owner(global_rows)
        parts = []
        for s in np.unique(owners):
            sel = global_rows[owners == s]
            parts.append((sel, self.blocks[int(s)][sel - s * rl.block]))
        if not parts:
            return _empty_csr(0, self.col_layout.Npad)
        order = np.argsort(np.concatenate([p[0] for p in parts]),
                           kind="stable")
        stacked = sp.vstack([p[1] for p in parts]).tocsr()
        return stacked[order] if not np.all(order == np.arange(len(order))) \
            else stacked

    def submatrix(self, rows, cols):
        """(rows x cols) sub-block as a NEW ShardedCSR over the same
        shard count: each destination shard fetches only ITS slice of the
        requested rows from their owners (fetch_rows — the distributed
        MatCreateSubMatrix pattern, mpiov.c/MatCreateSubMatrix_MPIAIJ)
        and compacts the columns; no shard ever holds the full operator."""
        import scipy.sparse as sp
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        P = self.nshards
        rl = Layout(len(rows), nshards=P)
        cl = Layout(len(cols), nshards=P)
        blocks = []
        for s in range(P):
            lo, hi = rl.range(s)
            if hi > lo:
                rsel = rows[lo:hi]
                # fetch_rows needs sorted input and returns sorted rows —
                # restore the CALLER's order (field ISes are arbitrary)
                order = np.argsort(rsel, kind="stable")
                inv = np.empty_like(order)
                inv[order] = np.arange(len(order))
                R = self.fetch_rows(rsel[order])[inv][:, cols]
            else:
                R = _empty_csr(0, len(cols))
            R = sp.csr_matrix(R)
            if R.shape != (rl.block, cl.Npad):
                R = sp.csr_matrix(
                    (R.data, R.indices,
                     np.concatenate([R.indptr,
                                     np.full(rl.block - R.shape[0],
                                             R.indptr[-1])])),
                    shape=(rl.block, cl.Npad))
            blocks.append(R)
        return ShardedCSR(blocks, rl, cl)

    # ---------------- algebra ----------------

    def diag_shards(self):
        """Per-shard diagonal (length block each), padded-space aligned."""
        out = []
        for s in range(self.nshards):
            lo = s * self.row_layout.block
            d = np.asarray(self.blocks[s][:, lo:lo + self.row_layout.block]
                           .diagonal())
            out.append(d)
        return out

    def scale_rows(self, per_shard_vals):
        import scipy.sparse as sp
        blocks = [sp.diags(v) @ b for v, b in
                  zip(per_shard_vals, self.blocks)]
        return ShardedCSR(blocks, self.row_layout, self.col_layout)

    def __mul__(self, alpha):
        return ShardedCSR([alpha * b for b in self.blocks],
                          self.row_layout, self.col_layout)

    def add(self, other):
        assert self.row_layout.compatible(other.row_layout)
        return ShardedCSR([a + b for a, b in
                           zip(self.blocks, other.blocks)],
                          self.row_layout, self.col_layout)

    def matvec(self, x):
        """y = A x with x a (col Npad,) host vector (setup-phase only)."""
        y = np.zeros(self.row_layout.Npad)
        blk = self.row_layout.block
        for s in range(self.nshards):
            y[s * blk:(s + 1) * blk] = self.blocks[s] @ x
        return y

    def transpose(self):
        """A^T as ShardedCSR: each shard's pieces routed to the column
        owner (the reverse-scatter structure of MatTranspose_MPIAIJ)."""
        import scipy.sparse as sp
        rl, cl = self.row_layout, self.col_layout
        per_dest = [[] for _ in range(cl.nshards)]
        for s in range(self.nshards):
            coo = self.blocks[s].tocoo()
            gi = coo.row + s * rl.block
            owners = cl.owner(coo.col)
            for t in range(cl.nshards):
                sel = owners == t
                if sel.any():
                    per_dest[t].append((coo.col[sel] - t * cl.block,
                                        gi[sel], coo.data[sel]))
        blocks = []
        for t in range(cl.nshards):
            if per_dest[t]:
                rows = np.concatenate([p[0] for p in per_dest[t]])
                cols = np.concatenate([p[1] for p in per_dest[t]])
                vals = np.concatenate([p[2] for p in per_dest[t]])
                blocks.append(sp.csr_matrix(
                    (vals, (rows, cols)), shape=(cl.block, rl.Npad)))
            else:
                blocks.append(_empty_csr(cl.block, rl.Npad))
        return ShardedCSR(blocks, Layout(cl.Npad, nshards=cl.nshards),
                          Layout(rl.Npad, nshards=rl.nshards))

    def spmm(self, P: "ShardedCSR"):
        """C = A @ P per shard: each shard fetches the P rows its column
        set touches (halo fetch), then multiplies locally — the
        "scalable" MatMatMult_MPIAIJ structure (mpimatmatmult.c)."""
        import scipy.sparse as sp
        blocks = []
        for s in range(self.nshards):
            A_s = self.blocks[s]
            need = np.unique(A_s.indices)
            if len(need) == 0:
                blocks.append(_empty_csr(self.row_layout.block,
                                         P.col_layout.Npad))
                continue
            P_ghost = P.fetch_rows(need)
            # compact A_s columns onto the fetched row set
            colmap = np.searchsorted(need, A_s.indices)
            A_c = sp.csr_matrix((A_s.data, colmap.astype(A_s.indptr.dtype),
                                 A_s.indptr),
                                shape=(A_s.shape[0], len(need)))
            from .. import native
            C = native.spgemm(A_c, P_ghost.tocsr())
            blocks.append(C if C is not None else (A_c @ P_ghost).tocsr())
        return ShardedCSR(blocks, self.row_layout, P.col_layout)

    def ptap(self, P: "ShardedCSR"):
        """Galerkin product P^T A P via W = A P then P^T W (the scalable
        MatPtAP pattern, mpiptap.c:215)."""
        W = self.spmm(P)
        return P.transpose().spmm(W)

    def prune(self, tol=0.0):
        for b in self.blocks:
            b.eliminate_zeros()
        return self
