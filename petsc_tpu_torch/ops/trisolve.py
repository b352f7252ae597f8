"""Level-scheduled sparse triangular solves: kernel T1 beside its plain version.

Counterpart of ``petsc_tpu/ops/trisolve.py`` (the role of MatSolve_SeqAIJ,
aijfact.c:2460, and of cuSPARSE's csrsv pair): the rows of a triangular
factor are grouped into dependency levels (a row depends only on rows of
earlier levels, found on the host by the native ``levels``), and a sweep
solves one level after the other. The reference pads each level's row
list to one width with a sentinel row and the factors to an ELL block,
for XLA's static shapes; the port keeps the same function in a compact
form, a :class:`Sweep`: the rows sorted by level behind a level pointer,
each row's entries in CSR in that order.

  trisolve  T1  csrc/trisolve.cu  ops/trisolve.py:94-119 trisolve_apply,
                                  sweeps :122, :138, :186

One sweep computes x[r] = (b[r] - sum_k a[r,k] x[col[r,k]]) * scale[r]
(no scale: 1) for the rows of each level in turn. ILU's two sweeps, the
transpose solve's two and SOR's unit sweeps are all such sweeps.
:func:`trisolve_sweep` launches T1 once per sweep for a CUDA tensor (no
level loop runs on the host) and adds one to ``LAUNCHES["trisolve"]``;
for a CPU tensor it runs :func:`trisolve_sweep_plain`, a Python loop over
levels. T1 has two variants, and :func:`sweep_plan` picks one per sweep
from its widest level: ``cluster`` (one thread-block cluster, one row of
the widest level per thread, the cluster's hardware barrier between
levels) where the widest level fits 16 blocks of 512 threads, else
``grid`` (one cooperative launch of 256-thread blocks, a grid barrier
between levels). Both load each row's x-independent operands two levels
ahead and keep x in level order (``Sweep.pcols``) while they sweep.
:func:`launch_config` reports the plan and what the card makes of it. There is no fallback from the kernel to the plain version, nor from
one variant to the other: a cluster the card cannot place raises. Both
round each product and sum on their own, summing a row's entries in
column order, so they give equal bits.

A plan made by :func:`make_trisolve_plan` keeps its factors in float64
whatever the vectors' type, as the reference's does (trisolve.py:84-89);
the sums then run in float64 and the result is rounded to the vector's
type. SOR's sweeps keep the real dtype (``pc/more_pc.py``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import config, native
from ..sys.error import Error
from . import cuda_build

# launches of each kernel since the last reset_launches()
LAUNCHES = {"trisolve": 0}

_VALUES = (torch.float64, torch.float32)
_INT32_MAX = 2 ** 31 - 1
# (device index, stream) -> the grid variant's barrier: two 32-bit counters
# zeroed once; every launch leaves the arrival count at 0, so no call needs
# a memset
_BARRIERS = {}
# (device index, vector and factor types, blocks, threads) of cluster
# launches that the card was found to place
_PLACED = set()
_GRID_THREADS = 256        # csrc/trisolve.cu kGridThreads
_CLUSTER_THREADS = 512     # kClusterThreads: threads of a cluster block at most
_CLUSTER_BLOCKS = 16       # kMaxCluster: blocks of one cluster at most
_DEPTH = 4                 # kDepth: entries of a row loaded before its level


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class Sweep:
    """One triangular factor in level order, on one device.

    ``lev_ptr`` (int32, nlev + 1) bounds each level's run of ``rows``
    (int32, the factor's row of each position); ``rp`` (int32, m + 1)
    bounds each position's entries in ``cols`` (int32) and ``vals``;
    ``scale`` (or None) is each position's scale. ``pcols`` (int32)
    holds each entry's column as a position in level order, which is where
    T1 keeps x while it sweeps. ``levels`` and ``widths`` are the host's
    copies of the level pointer and of each level's longest row;
    ``width`` is the most rows of one level."""
    m: int
    nlev: int
    lev_ptr: torch.Tensor
    rows: torch.Tensor
    rp: torch.Tensor
    cols: torch.Tensor
    pcols: torch.Tensor
    vals: torch.Tensor
    scale: torch.Tensor | None
    levels: tuple
    widths: tuple
    width: int

    @property
    def nnz(self):
        return int(self.cols.numel())


def levels_from_csr(indptr, indices, lower: bool):
    """Dependency levels of a strictly triangular CSR (host): (levels (m,),
    nlevels). lower: row i depends on its columns j < i (a forward sweep);
    else on its columns j > i (a backward sweep)."""
    return native.levels(np.asarray(indptr, dtype=np.int64),
                         np.asarray(indices, dtype=np.int64), lower)


def sweep_from_levels(lev, indptr, indices, vals, scale=None, dtype=torch.float64,
                      device=None):
    """A :class:`Sweep` of the CSR (indptr, indices, vals) whose row i lies
    in level lev[i]: rows sorted by level (in row order within a level),
    entries kept in each row's column order."""
    m = len(indptr) - 1
    indptr = np.asarray(indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    if m > _INT32_MAX or nnz > _INT32_MAX:
        raise Error(f"trisolve: T1's int32 indices take fewer than 2^31 rows and entries "
                    f"({m} rows, {nnz} entries)")
    lev = np.asarray(lev, dtype=np.int64)
    nlev = int(lev.max()) + 1 if m else 0
    order = np.argsort(lev, kind="stable")
    lev_ptr = np.concatenate([[0], np.cumsum(np.bincount(lev, minlength=nlev))])
    rl = np.diff(indptr)[order]
    rp = np.concatenate([[0], np.cumsum(rl)])
    ent = np.repeat(indptr[:-1][order] - rp[:-1], rl) + np.arange(nnz)
    longest = np.zeros(nlev, dtype=np.int64)
    np.maximum.at(longest, lev[order], rl)
    pos = np.empty(m, dtype=np.int64)
    pos[order] = np.arange(m)
    cols = np.asarray(indices, dtype=np.int64)[ent]
    dev = config.device() if device is None else torch.device(device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

    def val(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)

    return Sweep(m=m, nlev=nlev, lev_ptr=i32(lev_ptr), rows=i32(order), rp=i32(rp),
                 cols=i32(cols), pcols=i32(pos[cols]), vals=val(np.asarray(vals)[ent]),
                 scale=None if scale is None else val(np.asarray(scale)[order]),
                 levels=tuple(int(v) for v in lev_ptr), widths=tuple(int(v) for v in longest),
                 width=int(np.diff(lev_ptr).max()) if nlev else 0)


def make_sweep(indptr, indices, vals, lower, scale=None, dtype=torch.float64, device=None):
    """The :class:`Sweep` of a strictly lower (`lower`) or strictly upper
    CSR triangle, with an optional per-row scale."""
    lev, _ = levels_from_csr(indptr, indices, lower)
    return sweep_from_levels(lev, indptr, indices, vals, scale, dtype, device)


# ---------------------------------------------------------------------
# T1 and its plain version
# ---------------------------------------------------------------------

def trisolve_sweep_plain(sw: Sweep, b):
    """T1's function in PyTorch ops: a Python loop over the levels, each
    row's products taken with index_select and summed in column order from
    0, then b minus the sum, then the scale, in the promoted type."""
    acc_t = torch.promote_types(sw.vals.dtype, b.dtype)
    x = torch.zeros(sw.m, dtype=b.dtype, device=b.device)
    rows, rp = sw.rows.long(), sw.rp.long()
    cols, vals = sw.cols.long(), sw.vals.to(acc_t)
    scale = None if sw.scale is None else sw.scale.to(acc_t)
    for lv in range(sw.nlev):
        p0, p1 = sw.levels[lv], sw.levels[lv + 1]
        r = rows[p0:p1]
        e0 = rp[p0:p1]
        cnt = rp[p0 + 1:p1 + 1] - e0
        s = torch.zeros(p1 - p0, dtype=acc_t, device=b.device)
        for k in range(sw.widths[lv]):
            has = cnt > k
            e = torch.where(has, e0 + k, 0)
            prod = vals.index_select(0, e) * x.index_select(0, cols.index_select(0, e)).to(acc_t)
            s = s + torch.where(has, prod, 0.0)
        v = b.index_select(0, r).to(acc_t) - s
        if scale is not None:
            v = v * scale[p0:p1]
        x[r] = v.to(b.dtype)
    return x


@dataclass(frozen=True)
class SweepPlan:
    """T1's launch for one sweep. ``variant`` is "cluster" (one cluster of
    ``blocks`` blocks, one row of the widest level per thread) or "grid"
    (``blocks`` is what the widest level asks for at one row per thread;
    the card caps it at what it holds at once, see :func:`launch_config`);
    ``threads`` per block; ``longest``, the sweep's longest row (a row
    longer than the _DEPTH entries loaded ahead of its level loads the
    rest after the barrier)."""
    variant: str
    blocks: int
    threads: int
    longest: int


@lru_cache(maxsize=None)
def _plan(width, longest, max_blocks):
    if width <= max_blocks * _CLUSTER_THREADS:
        share = -(-width // max_blocks)
        threads = max(32, -(-share // 32) * 32)
        return SweepPlan("cluster", -(-width // threads), threads, longest)
    return SweepPlan("grid", -(-width // _GRID_THREADS), _GRID_THREADS, longest)


def sweep_plan(sw: Sweep, max_blocks=_CLUSTER_BLOCKS) -> SweepPlan:
    """T1's variant for `sw`, chosen once per (widest level, longest row):
    the cluster variant where the widest level fits one cluster of
    `max_blocks` blocks of _CLUSTER_THREADS threads at one row per thread
    (spread over as many blocks as the cluster allows, each with the
    fewest warps that hold its share, so that a level's loads and stores
    queue on more SMs), else the grid variant (max_blocks=0 forces it).
    The vector and factor types do not enter: every pair fits the same
    blocks without spilling."""
    return _plan(sw.width, max(sw.widths, default=0), max_blocks)


def _barrier(dev):
    """The grid variant's barrier on `dev` for the current stream, zeroed
    when first made (a dict lookup after that: no launch, no allocation)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    bar = _BARRIERS.get(key)
    if bar is None:
        bar = _BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return bar


def _card_config(sw: Sweep, plan: SweepPlan, dtype, device):
    """What the card makes of `plan` (ptt_trisolve_config): blocks,
    threads, blocks per SM, SMs, registers and spill bytes per thread, and
    the clusters of the plan's shape it holds at once (0: grid variant)."""
    cfg = (ctypes.c_int * 7)()
    cluster = plan.blocks if plan.variant == "cluster" else 0
    rc = cuda_build.library().ptt_trisolve_config(
        int(dtype == torch.float64), int(sw.vals.dtype == torch.float64), sw.width, cluster,
        plan.threads, device.index if device.index is not None else torch.cuda.current_device(),
        ctypes.addressof(cfg))
    cuda_build.check("trisolve", rc)
    return dict(zip(("grid", "threads", "blocks_per_sm", "sms", "registers", "spill_bytes",
                     "clusters_that_fit"), cfg))


def _launch(counts, sw: Sweep, b, x, plan: SweepPlan):
    """One launch of T1 in `plan`'s variant, x = the sweep of b; adds one
    to counts["trisolve"]. A cluster the card cannot place raises."""
    if plan.variant == "cluster":
        key = (b.device.index, b.dtype, sw.vals.dtype, plan.blocks, plan.threads)
        if key not in _PLACED:
            fit = _card_config(sw, plan, b.dtype, b.device)["clusters_that_fit"]
            if fit < 1:
                raise Error(f"trisolve: the card cannot place a cluster of {plan.blocks} "
                            f"blocks of {plan.threads} threads")
            _PLACED.add(key)
        cluster, bar = plan.blocks, 0
    else:
        cluster, bar = 0, _barrier(b.device).data_ptr()
    scale = 0 if sw.scale is None else sw.scale.data_ptr()
    xl = torch.empty_like(b)        # x in level order while the sweep runs
    cuda_build.launch(counts, "trisolve", b, x.data_ptr(), xl.data_ptr(), b.data_ptr(),
                      sw.lev_ptr.data_ptr(), sw.nlev, sw.rows.data_ptr(), sw.rp.data_ptr(),
                      sw.pcols.data_ptr(), sw.vals.data_ptr(), scale,
                      int(sw.vals.dtype == torch.float64), sw.width, cluster, plan.threads, bar)


def trisolve_sweep(sw: Sweep, b):
    """x of one sweep of `sw` applied to b (a new tensor of b's type)."""
    if not isinstance(b, torch.Tensor) or b.dtype not in _VALUES:
        raise TypeError("trisolve: b must be a float64 or float32 tensor")
    if b.dim() != 1 or b.numel() != sw.m or not b.is_contiguous():
        raise ValueError(f"trisolve: b must be a contiguous 1-D tensor of {sw.m} entries, "
                         f"got {tuple(b.shape)}")
    if b.device != sw.rows.device:
        raise ValueError(f"trisolve: b on {b.device}, the factor on {sw.rows.device}")
    if b.device.type == "cpu":
        return trisolve_sweep_plain(sw, b)
    if b.device.type != "cuda":
        raise ValueError(f"trisolve: unsupported device {b.device}")
    x = torch.empty_like(b)
    if sw.m:
        _launch(LAUNCHES, sw, b, x, sweep_plan(sw))
    return x


def launch_config(sw: Sweep, dtype, device, plan: SweepPlan | None = None):
    """T1's launch for a sweep of `sw` on vectors of `dtype` on CUDA
    `device` (`plan`, or the sweep's own): the plan's variant, cluster
    size (0 for the grid variant), depth and longest row, and what the
    card makes of it: blocks, threads per block, rows per thread of the
    widest level, blocks per SM (occupancy calculator), SMs, registers and
    spill bytes per thread, clusters of this shape the card holds at once."""
    plan = plan or sweep_plan(sw)
    card = _card_config(sw, plan, dtype, torch.device(device))
    return {"variant": plan.variant,
            "cluster": plan.blocks if plan.variant == "cluster" else 0,
            **card, "rows_per_thread": -(-sw.width // (card["grid"] * card["threads"])),
            "depth": _DEPTH, "longest_row": plan.longest}


# ---------------------------------------------------------------------
# the reference's solves
# ---------------------------------------------------------------------

def make_trisolve_plan(L, U, dinv, device=None):
    """Host symbolic phase. L: strict-lower CSR triple, U: strict-upper CSR
    triple (numpy), dinv: the inverse of U's diagonal. Returns ((m, nlevL,
    nlevU), data) for x = (D + U)^{-1} (I + L)^{-1} b; data["L"] and
    data["U"] are float64 :class:`Sweep`s, U's scaled by dinv."""
    sL = make_sweep(*L, lower=True, device=device)
    sU = make_sweep(*U, lower=False, scale=dinv, device=device)
    return (len(dinv), sL.nlev, sU.nlev), {"L": sL, "U": sU}


def trisolve_apply(data, b):
    """x = (D + U)^{-1} (I + L)^{-1} b: two sweeps."""
    return trisolve_sweep(data["U"], trisolve_sweep(data["L"], b))


def unit_lower_solve(sweep_l, b):
    """y = (I + L)^{-1} b for a strict-lower sweep without scale."""
    return trisolve_sweep(sweep_l, b)


def unit_upper_solve(sweep_u, b):
    """y = (I + U)^{-1} b for a strict-upper sweep without scale."""
    return trisolve_sweep(sweep_u, b)


def make_transpose_tables(L, U, dinv, device=None):
    """The sweeps of the transpose solve x = A^{-T} b = (I + L)^{-T}
    (D + U)^{-T} b (MatSolveTranspose_SeqAIJ): (D + U)^T = D + U^T is
    lower triangular (a forward sweep scaled by dinv), (I + L)^T = I + L^T
    unit upper (a backward sweep). Returns {"Ut": ..., "Lt": ...} to merge
    into a plan's data; each has as many levels as the forward plan's
    sweep of the same factor (the longest dependency chain of a DAG does
    not change when its edges turn round)."""
    import scipy.sparse as sp
    m = len(dinv)
    Lt = sp.csr_matrix((L[2], L[1], L[0]), shape=(m, m)).T.tocsr()   # strict upper
    Ut = sp.csr_matrix((U[2], U[1], U[0]), shape=(m, m)).T.tocsr()   # strict lower
    Lt.sort_indices()
    Ut.sort_indices()
    return {"Ut": make_sweep(Ut.indptr, Ut.indices, Ut.data, lower=True, scale=dinv,
                             device=device),
            "Lt": make_sweep(Lt.indptr, Lt.indices, Lt.data, lower=False, device=device)}


def trisolve_transpose_apply(data, b):
    """x = (I + L)^{-T} (D + U)^{-T} b; needs make_transpose_tables' sweeps."""
    return trisolve_sweep(data["Lt"], trisolve_sweep(data["Ut"], b))
