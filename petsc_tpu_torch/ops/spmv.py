"""Sparse matrix-vector products and COO re-assembly in plain PyTorch.

Counterpart of ``petsc_tpu/ops/spmv.py`` for the layouts the port keeps.
``csr_spmv`` and ``csr_spmv_t`` are the reference's CSR-segment form
(``csr_seg_spmv`` and ``_t``, with row pointers in place of per-entry row
ids): the CPU path of ``A x``, whose card path is the hand kernel S2
(:func:`.pallas_kernels.csr_spmv`), and the transpose product on either
device. ``ell_spmv`` and ``_t`` have no caller in the package: the port
stores no ELL, and they serve the tests as oracles of the reference's ELL
products. ``coo_scatter_csr`` is the COO numeric assembly of
:meth:`petsc_tpu_torch.mat.aij.MatAIJ.setValuesCOO`, its gather through
the K8 wrapper.
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


def ell_spmv(data, idx, x):
    """y = A x for ELL storage (m, K): y[i] = sum_k data[i,k] x[idx[i,k]]
    (spmv.py:25-27); padding entries hold data 0."""
    return torch.sum(data * x[idx.long()], dim=1)


def ell_spmv_t(data, idx, x, n):
    """y = A^T x for ELL storage (spmv.py:34-37)."""
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    return y.index_add_(0, idx.reshape(-1).long(), (data * x[:, None]).reshape(-1))


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
