"""Hand-written Hopper kernels of the block systems, beside their plain versions.

The JAX package left both functions to XLA on the TPU (jnp code, no
Pallas); they run in every cycle of GAMG on a block system, so here each
is a CUDA C++ kernel for sm_90a (sources in ``petsc_tpu_torch/csrc``, built
and loaded by :mod:`.cuda_build`):

  bsr_spmv         B1  csrc/bsr_spmv.cu   mat/aij.py:1494-1504 _bind_aij_bell mult
  agg_block_apply  A1  csrc/agg_block.cu  pc/mg.py:516-525 (the asm_agg smoother's apply)

Every wrapper checks device, dtype (float64 or float32), shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream without synchronising and adds one to ``LAUNCHES[name]``.
A tensor on the CPU takes the plain PyTorch version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

# launches of each kernel since the last reset_launches()
LAUNCHES = {"bsr_spmv": 0, "agg_block_apply": 0}

_VALUES = (torch.float64, torch.float32)
MAX_BS = 8          # B1: block sizes 2, 3, 4 and 6 compiled, others up to 8 at run time
AGG_ROWS = 16       # A1: rows of one aggregate per work item (4 warps x 4 rows)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, t, dtypes, ndim=1):
    if not isinstance(t, torch.Tensor) or t.dtype not in dtypes:
        raise TypeError(f"{name}: expected a tensor of {dtypes}, got "
                        f"{getattr(t, 'dtype', type(t).__name__)}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _same_device(name, *ts):
    if len({t.device for t in ts}) > 1:
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in ts})}")


# ---------------------------------------------------------------------
# B1: y = A x for A in BSR form
# ---------------------------------------------------------------------

def bsr_spmv_plain(indptr, bcol, vals, x):
    """B1's function in PyTorch ops, in B1's order: each block's inner sum
    over c, then the block row's sum over its blocks in order from 0."""
    bs = vals.shape[1]
    mb = indptr.numel() - 1
    g = x.view(-1, bs)[bcol.long()]                      # (nblocks, bs)
    t = vals[:, :, 0] * g[:, None, 0]
    for c in range(1, bs):
        t = t + vals[:, :, c] * g[:, None, c]
    y = torch.zeros(mb, bs, dtype=x.dtype, device=x.device)
    lens = indptr[1:] - indptr[:-1]
    start = indptr[:-1]
    for p in range(int(lens.max()) if mb else 0):
        rows = torch.nonzero(lens > p)[:, 0]
        y[rows] = y[rows] + t[start[rows] + p]
    return y.reshape(-1)


def bsr_spmv(indptr, bcol, vals, x):
    """y = A x: int64 `indptr` (mb + 1) block-row pointers, int32 `bcol`
    block columns, `vals` (nblocks, bs, bs) row-major, x of nb bs entries.
    The columns are not checked against x (that would read the card): the
    layout that made them checked them on the host."""
    _check("bsr_spmv", indptr, (torch.int64,))
    _check("bsr_spmv", bcol, (torch.int32,))
    _check("bsr_spmv", vals, _VALUES, ndim=3)
    _check("bsr_spmv", x, _VALUES)
    _same_device("bsr_spmv", indptr, bcol, vals, x)
    bs = vals.shape[1]
    if vals.dtype != x.dtype:
        raise TypeError(f"bsr_spmv: vals are {vals.dtype}, x is {x.dtype}")
    if vals.shape[2] != bs or not 1 <= bs <= MAX_BS:
        raise ValueError(f"bsr_spmv: blocks of shape {tuple(vals.shape[1:])} (square, "
                         f"1 to {MAX_BS})")
    if bcol.numel() != vals.shape[0] or indptr.numel() < 1 or x.numel() % bs:
        raise ValueError(f"bsr_spmv: {bcol.numel()} block columns, {vals.shape[0]} blocks, "
                         f"{indptr.numel()} row pointers, x of {x.numel()}")
    if x.device.type == "cpu":
        return bsr_spmv_plain(indptr, bcol, vals, x)
    mb = indptr.numel() - 1
    y = torch.empty(mb * bs, dtype=x.dtype, device=x.device)
    if mb:
        cuda_build.launch(LAUNCHES, "bsr_spmv", x, y.data_ptr(), indptr.data_ptr(),
                          bcol.data_ptr(), vals.data_ptr(), x.data_ptr(), mb, bs)
    return y


def bsr_transpose(indptr, bcol, vals, nb):
    """The BSR of A^T for a BSR A with nb block columns, on A's device:
    blocks moved to their column's row in block-row order and transposed."""
    mb = indptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(mb, device=indptr.device),
                                   indptr[1:] - indptr[:-1])
    order = torch.argsort(bcol.long() * max(mb, 1) + rows, stable=True)
    tptr = torch.zeros(nb + 1, dtype=torch.int64, device=indptr.device)
    tptr[1:] = torch.cumsum(torch.bincount(bcol.long(), minlength=nb), 0)
    return tptr, rows[order].to(torch.int32), vals[order].transpose(1, 2).contiguous()


# ---------------------------------------------------------------------
# A1: z = M^-1 r for the aggregate-block smoother
# ---------------------------------------------------------------------

def size_runs(ks):
    """(first, end) of each run of equal values in the sizes `ks`."""
    bounds = np.flatnonzero(np.diff(ks)) + 1
    return list(zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [len(ks)]])))


def agg_block_tables(dof_lists, inv_flat, device, dtype):
    """The device tables of A1 and of its plain version from the host's
    ragged tables: `dof_lists` (an int64 array per block, in the order of
    the blocks, which come grouped by size) and `inv_flat` (each block's
    k x k inverse, row-major, one after the other). Returns a dict:
    dofs, dptr, inv, iptr and work (A1's (block, first row, rows) items of
    at most AGG_ROWS rows), max_k, and groups ((dof index (na, k), first
    inverse entry, na, k) per size, for the plain version)."""
    ks = np.array([len(d) for d in dof_lists], dtype=np.int64)
    dptr = np.concatenate([[0], np.cumsum(ks)])
    iptr = np.concatenate([[0], np.cumsum(ks * ks)])
    per = -(-ks // AGG_ROWS)
    item_blk = np.repeat(np.arange(len(ks)), per)
    item_first = (np.arange(len(item_blk)) - np.repeat(np.cumsum(per) - per, per)) * AGG_ROWS
    item_rows = np.minimum(AGG_ROWS, ks[item_blk] - item_first)
    work = np.stack([item_blk, item_first, item_rows], axis=1).astype(np.int32)
    dofs = np.concatenate(dof_lists).astype(np.int64)
    t = {"dofs": torch.as_tensor(dofs.astype(np.int32), device=device),
         "dptr": torch.as_tensor(dptr, device=device),
         "inv": torch.as_tensor(inv_flat, dtype=dtype, device=device),
         "iptr": torch.as_tensor(iptr, device=device),
         "work": torch.as_tensor(work.reshape(-1), device=device),
         "max_k": int(ks.max()) if len(ks) else 0, "groups": []}
    for lo, hi in size_runs(ks):
        k = int(ks[lo])
        idx = dofs[dptr[lo]:dptr[hi]].reshape(hi - lo, k)
        t["groups"].append((torch.as_tensor(idx, device=device), int(iptr[lo]), int(hi - lo), k))
    return t


def agg_block_apply_plain(tab, r):
    """A1's function in PyTorch ops: one batched product per block size."""
    z = torch.empty_like(r)
    inv = tab["inv"]
    for idx, i0, na, k in tab["groups"]:
        B = inv[i0:i0 + na * k * k].view(na, k, k)
        z[idx] = torch.bmm(B, r[idx][:, :, None])[:, :, 0]
    return z


def agg_block_apply(tab, r):
    """z = M^-1 r: on each block's dofs d, z[d] = B r[d] with B the
    inverse of the operator's diagonal block there (the tables of
    :func:`agg_block_tables`, on r's device and in r's dtype)."""
    _check("agg_block_apply", r, _VALUES)
    inv = tab["inv"]
    if inv.dtype != r.dtype or inv.device != r.device:
        raise TypeError(f"agg_block_apply: tables {inv.dtype} on {inv.device}, r {r.dtype} "
                        f"on {r.device}")
    if tab["dofs"].numel() != r.numel():
        raise ValueError(f"agg_block_apply: tables for {tab['dofs'].numel()} dofs, r of "
                         f"{r.numel()}")
    if r.device.type == "cpu":
        return agg_block_apply_plain(tab, r)
    if tab["max_k"] * r.element_size() > 227 * 1024:
        raise ValueError(f"agg_block_apply: a block of {tab['max_k']} dofs exceeds the "
                         "shared memory of one thread block")
    z = torch.empty_like(r)
    nitems = tab["work"].numel() // 3
    if nitems:
        cuda_build.launch(LAUNCHES, "agg_block_apply", r, z.data_ptr(), r.data_ptr(),
                          tab["dofs"].data_ptr(), tab["dptr"].data_ptr(), inv.data_ptr(),
                          tab["iptr"].data_ptr(), tab["work"].data_ptr(), nitems, tab["max_k"])
    return z
