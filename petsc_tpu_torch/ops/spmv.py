"""Sparse matrix-vector products and COO re-assembly in plain PyTorch.

Counterpart of ``petsc_tpu/ops/spmv.py``. ``csr_spmv`` is the
reference's CSR-segment form (``csr_seg_spmv``, with row pointers in
place of per-entry row ids): the CPU path of ``A x``, whose card path is
the hand kernel S2 (:func:`.pallas_kernels.csr_spmv`); ``csr_spmm`` is
the CPU path of M1 (:func:`.pallas_kernels.csr_spmm`), ``A X`` for a
block X. ``csr_spmv_t`` (the scatter-add ``csr_seg_spmv_t``) is kept for
the tests: the port's transpose product is S2 on an explicit transpose
(:func:`petsc_tpu_torch.mat.aij.csr_transpose_of`). The ELL, DIA, HYB
and BDIA products are the reference's functions in plain PyTorch, for
their results only: the port stores none of those layouts (every layout
name gives CSR, whose results they equal), so they have no caller in the
package and serve the tests as oracles. ``coo_scatter_csr`` is the COO
numeric assembly of :meth:`petsc_tpu_torch.mat.aij.MatAIJ.setValuesCOO`,
its gather through the K8 wrapper.
"""

from __future__ import annotations

import torch

from .gather_kernels import gather


def row_ids(indptr):
    """The row of every stored entry: (nnz,) int64."""
    m = indptr.numel() - 1
    return torch.repeat_interleave(torch.arange(m, device=indptr.device),
                                   indptr[1:] - indptr[:-1])


def csr_spmv(indptr, col, vals, x):
    """y = A x: y[i] = sum over row i's entries of vals[k] * x[col[k]]
    (csr_seg_spmv, spmv.py:45-47)."""
    m = indptr.numel() - 1
    y = torch.zeros(m, dtype=x.dtype, device=x.device)
    return y.index_add_(0, row_ids(indptr), vals * x[col.long()])


def csr_spmv_t(indptr, col, vals, x, n):
    """y = A^T x for A with n columns (csr_seg_spmv_t, spmv.py:50-51)."""
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    return y.index_add_(0, col.long(), vals * x[row_ids(indptr)])


def csr_spmm(indptr, col, vals, X):
    """Y = A X for an (n, k) block X: Y[i, :] = sum over row i's entries
    of vals[p] X[col[p], :] (ell_spmm's function, spmv.py:40-42, on CSR).
    The plain version of M1 (:func:`.pallas_kernels.csr_spmm`)."""
    m = indptr.numel() - 1
    Y = torch.zeros((m, X.shape[1]), dtype=X.dtype, device=X.device)
    return Y.index_add_(0, row_ids(indptr), vals[:, None] * X[col.long()])


def ell_spmm(data, idx, X):
    """Y = A X for ELL storage (m, K) and an (n, k) block X (spmv.py:40-42)."""
    return torch.sum(data[:, :, None] * X[idx.long()], dim=1)


def ell_spmv(data, idx, x):
    """y = A x for ELL storage (m, K): y[i] = sum_k data[i,k] x[idx[i,k]]
    (spmv.py:25-27); padding entries hold data 0."""
    return torch.sum(data * x[idx.long()], dim=1)


def ell_spmv_t(data, idx, x, n):
    """y = A^T x for ELL storage (spmv.py:34-37)."""
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    return y.index_add_(0, idx.reshape(-1).long(), (data * x[:, None]).reshape(-1))


def dia_spmv(data, offsets, x, m, lpad, rpad):
    """y = A x for DIA storage: y[i] = sum_k data[k, i] x[i + off_k]
    (spmv.py:54-67); x padded by lpad on the left, rpad on the right."""
    xp = torch.nn.functional.pad(x, (lpad, rpad))
    acc = torch.zeros(m, dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        acc = acc + data[k] * xp[lpad + off: lpad + off + m]
    return acc


def dia_spmv_t(data, offsets, x, n, m, lpad, rpad):
    """y = A^T x for DIA storage: y[i + off] += data[k, i] x[i], summed in
    a padded buffer that covers every write window (spmv.py:70-85)."""
    maxoff = max([0] + [int(o) for o in offsets])
    acc = torch.zeros(lpad + max(m + rpad, maxoff + m, n), dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        acc[lpad + off: lpad + off + m] += data[k] * x
    return acc[lpad: lpad + n]


def hyb_spmv(dia_data, offsets, sdata, sidx, x, m, lpad, rpad):
    """y = A x for HYB storage: the DIA streams plus the spilled entries as
    COO (srows, scols) = sidx (spmv.py:88-111)."""
    y = dia_spmv(dia_data, offsets, x, m, lpad, rpad)
    if sdata is not None:
        y = y.index_add(0, sidx[0].long(), sdata * x[sidx[1].long()])
    return y


def hyb_spmv_t(dia_data, offsets, sdata, sidx, x, n, m, lpad, rpad):
    """y = A^T x for HYB storage (spmv.py:114-119)."""
    y = dia_spmv_t(dia_data, offsets, x, n, m, lpad, rpad)
    if sdata is not None:
        y = y.index_add(0, sidx[1].long(), sdata * x[sidx[0].long()])
    return y


def _onehot_select(V, lanes):
    """sel[..., k] = V[..., lanes[..., k]] for V of shape (..., 128), its
    leading dimensions broadcast against lanes' (spmv.py:122-139; the TPU's
    one-hot contraction selects exactly the value a gather reads)."""
    return torch.gather(V.expand(*lanes.shape[:-1], V.shape[-1]), -1, lanes.long())


def bdia_spmv(joffs, jmin, jmax, data, lanes, spill, x, m):
    """y = A x for BDIA-ELL storage (spmv.py:142-177): column c = 128 (r //
    128 + j) + s, entries bucketed by the block offset j (joffs), each
    bucket's (G * 128, K) values and lane ids; spill is None or the COO
    (srows, scols, svals) of the entries past K."""
    G = data.shape[1] // 128
    x2 = torch.nn.functional.pad(x[:m], (0, G * 128 - m)).reshape(G, 128)
    xp = torch.nn.functional.pad(x2, (0, 0, -jmin, jmax))
    y = torch.zeros((G, 128), dtype=x.dtype, device=x.device)
    for j, d, lv in zip(joffs.tolist(), data, lanes):
        V = xp[j - jmin: j - jmin + G]
        sel = _onehot_select(V[:, None, :], lv.reshape(G, 128, -1))
        y = y + torch.sum(d.reshape(G, 128, -1) * sel, dim=2)
    y = y.reshape(-1)[:m]
    if spill is not None:
        srows, scols, svals = spill
        y = y.index_add(0, srows.long(), svals * x[scols.long()])
    if x.shape[0] > m:
        y = torch.nn.functional.pad(y, (0, x.shape[0] - m))
    return y


def bdia_spmv_t(joffs, jmin, jmax, data, lanes, spill, x, m, n):
    """y = A^T x for BDIA-ELL storage (spmv.py:180-209): each bucket
    scattered back by +j with the lane pick inverted."""
    G = data.shape[1] // 128
    x2 = torch.nn.functional.pad(x[:m], (0, G * 128 - m)).reshape(G, 128)
    acc = torch.zeros((G + jmax - jmin, 128), dtype=x.dtype, device=x.device)
    gidx = torch.arange(G, device=x.device).repeat_interleave(128 * data.shape[2])
    for j, d, lv in zip(joffs.tolist(), data, lanes):
        w = (d.reshape(G, 128, -1) * x2[:, :, None]).reshape(-1)
        contrib = torch.zeros((G, 128), dtype=x.dtype, device=x.device).index_put_(
            (gidx, lv.reshape(-1).long()), w, accumulate=True)
        acc[j - jmin: j - jmin + G] += contrib
    y = acc[-jmin: -jmin + G].reshape(-1)[:n]
    if spill is not None:
        srows, scols, svals = spill
        y = y.index_add(0, scols.long(), svals * x[srows.long()])
    if x.shape[0] > n:
        y = torch.nn.functional.pad(y, (0, x.shape[0] - n))
    return y


def coo_scatter_csr(perm, seg_ids, coo_vals, nnz, check=True):
    """Numeric COO re-assembly (spmv.py:212-216): user-order values into
    CSR value order, duplicates summed: out[seg_ids[k]] += coo_vals[perm[k]].
    The gather is K8 (int32 ``perm``; ``check`` as in
    :func:`.gather_kernels.gather`). ``seg_ids`` None says that no two
    entries share a slot, so the gathered values are the result and the
    sum is skipped."""
    out = gather(coo_vals, perm, check=check)
    if seg_ids is None:
        return out
    return torch.zeros(nnz, dtype=coo_vals.dtype, device=coo_vals.device) \
        .index_add_(0, seg_ids.long(), out)
