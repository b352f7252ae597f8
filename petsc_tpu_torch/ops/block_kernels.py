"""Hand-written Hopper kernels of the block systems, beside their plain versions.

The JAX package left both functions to XLA on the TPU (jnp code, no
Pallas); they run in every cycle of GAMG on a block system, so here each
is a CUDA C++ kernel for sm_90a (sources in ``petsc_tpu_torch/csrc``, built
and loaded by :mod:`.cuda_build`):

  bsr_spmv         B1  csrc/bsr_spmv.cu   mat/aij.py:1494-1504 _bind_aij_bell mult
  agg_block_apply  A1  csrc/agg_block.cu  pc/mg.py:516-525 (the asm_agg smoother's apply)
  agg_block_cheby  A1  csrc/agg_block.cu  the same, with C1's z mode as its epilogue
                                          (ksp/cheby.py:36-37, :42-43, :79-80)

Every wrapper checks device, dtype (float64 or float32), shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream without synchronising and adds one to ``LAUNCHES[name]``.
A tensor on the CPU takes the plain PyTorch version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .pallas_kernels import cheby_update_z_plain

# launches of each kernel since the last reset_launches()
LAUNCHES = {"bsr_spmv": 0, "agg_block_apply": 0, "agg_block_cheby": 0}

_VALUES = (torch.float64, torch.float32)
MAX_BS = 8                # B1: block sizes 2, 3, 4 and 6 compiled, others up to 8 at run time
B1_CHUNK_ELEMS = 1536     # B1: inner sums per chunk (csrc/bsr_spmv.cu kChunkElems)
B1_STAGE_VALUES = 4608    # B1: values per chunk, at most (kStageValues)
AGG_ITEM_ENTRIES = 16384  # A1: entries of B per work item, about
AGG_SMALL_K = 16          # A1: blocks of at most this many dofs read r directly (kSmallK)
AGG_ROW_STEP = 32         # A1: rows of one pass of the warps (8 warps x kRows)
AGG_SPLIT_K = 512         # A1: from this many dofs the threads share each row (kSplitK)
AGG_SPLIT_ROWS = 8        # A1: rows of one pass there (kSplitRows)


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
                          bcol.data_ptr(), vals.data_ptr(), x.data_ptr(), mb, vals.shape[0], bs)
    return y


def bsr_chunk(bs):
    """B1's blocks per chunk for blocks of bs x bs."""
    return min(B1_CHUNK_ELEMS // bs, B1_STAGE_VALUES // (bs * bs))


def bsr_plan(indptr, bs, grid):
    """B1's cuts, as the kernel makes them, for block-row pointers `indptr`
    (host int64) and a launch of `grid` thread blocks: a dict of chunk
    (blocks per chunk: the chunk edges are its multiples) and, per thread
    block, runs ((first, end) chunk), rows ((first, end) block row owned:
    those whose first block lies in the run; the last block also owns the
    trailing empty rows) and chunks (the (first, end) block of each chunk
    it streams, from its first row's first block to its last row's end)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    mb, nblocks = len(indptr) - 1, int(indptr[-1])
    C = bsr_chunk(bs)
    nchunks = -(-nblocks // C) if nblocks else 1
    first = lambda key: min(int(np.searchsorted(indptr, key, side="left")), mb)  # noqa: E731
    plan = {"chunk": C, "runs": [], "rows": [], "chunks": []}
    for b in range(grid):
        t0, t1 = nchunks * b // grid, nchunks * (b + 1) // grid
        r_lo = 0 if b == 0 else first(t0 * C)
        r_hi = mb if b == grid - 1 else first(t1 * C)
        e0, e1 = int(indptr[r_lo]), int(indptr[r_hi])
        edges = [e0] + list(range((e0 // C + 1) * C, e1, C)) + [e1] if e1 > e0 else [e0, e0]
        plan["runs"].append((t0, t1))
        plan["rows"].append((r_lo, r_hi))
        plan["chunks"].append(list(zip(edges[:-1], edges[1:])))
    return plan


def bsr_launch_config(nblocks, bs, dtype, device):
    """B1's launch on a CUDA `device` for nblocks blocks of bs x bs, as the
    card would make it (without launching): grid, threads, chunk (blocks),
    stages, shared bytes per thread block, blocks per SM, SMs."""
    cfg = (ctypes.c_int * 7)()
    fn = cuda_build.library().ptt_bsr_spmv_config
    cuda_build.check("bsr_spmv config", fn(int(nblocks), int(bs),
                                           torch.empty((), dtype=dtype).element_size(),
                                           torch.device(device).index or 0, cfg))
    return dict(zip(("grid", "threads", "chunk", "stages", "smem", "per_sm", "sms"), cfg))


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


def agg_work(ks, entries=AGG_ITEM_ENTRIES):
    """A1's work list for blocks of sizes `ks` (grouped by size): one
    (block, first row, rows) item per thread block, the rows counted from
    the block's first row along its run of blocks of one size. Where k^2
    <= entries an item holds m = entries // k^2 whole blocks of the run
    (first row 0, m k rows); else each block is cut into items of the
    multiple of the kernel's pass (AGG_SPLIT_ROWS rows from AGG_SPLIT_K
    dofs on, else AGG_ROW_STEP) nearest entries / k, at least one pass and
    at most k rows. Returns an (nitems, 3) int32 array."""
    ks = np.asarray(ks, dtype=np.int64)
    parts = [np.zeros((0, 3), np.int64)]
    for lo, hi in size_runs(ks) if len(ks) else ():
        k = int(ks[lo])
        if k * k <= entries and k < AGG_SPLIT_K:
            m = entries // (k * k)
            first = np.arange(lo, hi, m)
            parts.append(np.stack([first, np.zeros_like(first),
                                   np.minimum(m, hi - first) * k], axis=1))
        else:
            step = AGG_SPLIT_ROWS if k >= AGG_SPLIT_K else AGG_ROW_STEP
            nr = min(k, max(1, round(entries / k / step)) * step)
            i0 = np.arange(0, k, nr)
            blk = np.repeat(np.arange(lo, hi), len(i0))
            first = np.tile(i0, hi - lo)
            parts.append(np.stack([blk, first, np.minimum(nr, k - first)], axis=1))
    return np.concatenate(parts).astype(np.int32)


def agg_stage(ks, work):
    """The most values of r one of A1's items stages in shared memory: the
    dofs of the blocks its rows lie in, for items of blocks above
    AGG_SMALL_K dofs (those of at most AGG_SMALL_K read r directly)."""
    ks = np.asarray(ks, dtype=np.int64)
    if not len(work):
        return 0
    blk, i0, nr = (np.asarray(work[:, c], dtype=np.int64) for c in range(3))
    k = ks[blk]
    n = ((i0 + nr + k - 1) // k - i0 // k) * k
    return int(np.max(np.where(k > AGG_SMALL_K, n, 0)))


def agg_block_tables(dof_lists, inv_flat, device, dtype):
    """The device tables of A1 and of its plain version from the host's
    ragged tables: `dof_lists` (an int64 array per block, in the order of
    the blocks, which come grouped by size; together they hold each of 0,
    ..., n - 1 once, which A1's single store per dof and its fused step
    rely on) and `inv_flat` (each block's k x k inverse, row-major, one
    after the other). Returns a dict:
    dofs, dptr, inv, iptr and work (A1's items, :func:`agg_work`), max_k,
    stage (:func:`agg_stage`) and groups ((dof index (na, k), first inverse
    entry, na, k) per size, for the plain version)."""
    ks = np.array([len(d) for d in dof_lists], dtype=np.int64)
    dptr = np.concatenate([[0], np.cumsum(ks)])
    iptr = np.concatenate([[0], np.cumsum(ks * ks)])
    work = agg_work(ks)
    dofs = np.concatenate(dof_lists).astype(np.int64)
    if not np.array_equal(np.sort(dofs), np.arange(len(dofs))):
        raise ValueError(f"agg_block_tables: the blocks' {len(dofs)} dofs repeat or miss one of "
                         f"0..{len(dofs) - 1}")
    t = {"dofs": torch.as_tensor(dofs.astype(np.int32), device=device),
         "dptr": torch.as_tensor(dptr, device=device),
         "inv": torch.as_tensor(inv_flat, dtype=dtype, device=device),
         "iptr": torch.as_tensor(iptr, device=device),
         "work": torch.as_tensor(work.reshape(-1), device=device),
         "max_k": int(ks.max()) if len(ks) else 0, "stage": agg_stage(ks, work),
         "groups": []}
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
    if tab["stage"] * r.element_size() > 227 * 1024:
        raise ValueError(f"agg_block_apply: an item stages {tab['stage']} values of r, more "
                         "than the shared memory of one thread block holds")
    z = torch.empty_like(r)
    nitems = tab["work"].numel() // 3
    if nitems:
        cuda_build.launch(LAUNCHES, "agg_block_apply", r, z.data_ptr(), r.data_ptr(),
                          tab["dofs"].data_ptr(), tab["dptr"].data_ptr(), inv.data_ptr(),
                          tab["iptr"].data_ptr(), tab["work"].data_ptr(), nitems, tab["stage"])
    return z


_AGG_CHEBY_MODES = {"first_z": 0, "step_z": 1}


def agg_block_cheby_plain(tab, r, mode, p, x, c, beta=1.0, a=0.0):
    """agg_block_cheby's function in PyTorch ops: A1's plain version, then
    C1's z mode's on its z."""
    return cheby_update_z_plain(mode, p, x, agg_block_apply_plain(tab, r), c, beta, a)


def _overlap(s, t):
    """Whether the memory of two tensors overlaps."""
    a, b = s.data_ptr(), t.data_ptr()
    return a < b + t.numel() * t.element_size() and b < a + s.numel() * s.element_size()


def agg_block_cheby(tab, r, mode, p, x, c, beta=1.0, a=0.0):
    """The tail of one Chebyshev smoothing step with the aggregate-block PC
    in one launch of A1: z = M^-1 r (agg_block_apply) finished at its store
    by C1's z mode (first_z: p = c z; step_z: p = a p + c z; then x +=
    beta p), with no z written. p and x are updated in place and must not
    overlap each other or r (the kernel stages r while it writes them).
    Returns (p, x)."""
    if mode not in _AGG_CHEBY_MODES:
        raise ValueError(f"agg_block_cheby: mode must be 'first_z' or 'step_z', got {mode!r}")
    for t in (r, p, x):
        _check("agg_block_cheby", t, _VALUES)
    _same_device("agg_block_cheby", r, p, x)
    inv = tab["inv"]
    if not (inv.dtype == r.dtype == p.dtype == x.dtype) or inv.device != r.device:
        raise TypeError(f"agg_block_cheby: tables {inv.dtype} on {inv.device}, r {r.dtype}, "
                        f"p {p.dtype}, x {x.dtype} on {r.device}")
    if not tab["dofs"].numel() == r.numel() == p.numel() == x.numel():
        raise ValueError(f"agg_block_cheby: tables for {tab['dofs'].numel()} dofs, r of "
                         f"{r.numel()}, p of {p.numel()}, x of {x.numel()}")
    if r.numel() and (_overlap(p, r) or _overlap(x, r) or _overlap(p, x)):
        raise ValueError("agg_block_cheby: p, x and r must be three separate buffers")
    if r.device.type == "cpu":
        return agg_block_cheby_plain(tab, r, mode, p, x, c, beta, a)
    if tab["stage"] * r.element_size() > 227 * 1024:
        raise ValueError(f"agg_block_cheby: an item stages {tab['stage']} values of r, more "
                         "than the shared memory of one thread block holds")
    nitems = tab["work"].numel() // 3
    if nitems:
        cuda_build.launch(LAUNCHES, "agg_block_cheby", r, _AGG_CHEBY_MODES[mode], p.data_ptr(),
                          x.data_ptr(), r.data_ptr(), tab["dofs"].data_ptr(),
                          tab["dptr"].data_ptr(), inv.data_ptr(), tab["iptr"].data_ptr(),
                          tab["work"].data_ptr(), nitems, tab["stage"], float(a), float(c),
                          float(beta))
    return p, x
