"""Hand-written Hopper kernels of DMSwarm's particle-mesh coupling, beside
their plain versions.

The JAX package computes both in jnp (``petsc_tpu/dm/swarm.py:166-254``),
left to XLA on the TPU: a cloud-in-cell scatter-add for the deposit and the
adjoint gather for the interpolation. Here each is a CUDA C++ kernel for
sm_90a (``petsc_tpu_torch/csrc/swarm_cic.cu``, built and loaded by
:mod:`.cuda_build`):

  cic_deposit  W1  acc[k][nid] = sum of w * f_k[p], and acc[nf][nid] = sum
                   of w with ``wsum`` (depositSum, projectFields), one
                   launch for up to four fields
  cic_interp   W2  out[p] = sum_c w_c * v[nid_c] (interpolateToParticles)

For particle p: its cell i0 = clip(floor(x / h), 0, ncell - 1) and
fractions t = x / h - i0 per axis; for each of the 2^dim corners c (the
last axis fastest) the weight prod_ax (c_ax ? t_ax : 1 - t_ax) in axis
order and the node (...((i0_0 + c_0) * sizes_1 + i0_1 + c_1) ...), the
reference's numbering. The plain deposit (the reference's corner loop with
``index_add_``) adds in a fixed order on the CPU: for each node, corner 0's
particles in ascending index, then corner 1's, and so on. W1 sums each
node in that same order, with no atomics, from the particles' cell order
(:func:`cell_order`: a stable sort by cell, PETSc's DMSwarmSortGetAccess),
so it equals the plain version run on the CPU bit for bit, in f64 and f32;
W2 rounds each step as the plain version does and equals it bit for bit.
Every wrapper checks its operands, launches on the current stream without
synchronising and adds one to ``LAUNCHES[name]``. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build

# launches of each kernel since the last reset_launches()
LAUNCHES = {"cic_deposit": 0, "cic_interp": 0}

MAX_FIELDS = 4          # fields one W1 launch deposits (kMaxFields in swarm_cic.cu)
MAX_NODES = 2**31 - 1   # the kernels and the plain versions number nodes in int32
# W1's tile of nodes a block per dimension (swarm_cic.cu tile_ext): for a
# permuted swarm, and for one in cell order
W1_TILES = {1: ((256,), (128,)), 2: ((8, 32), (8, 16)), 3: ((4, 8, 8), (4, 4, 8))}
_VALUES = (torch.float64, torch.float32)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Grid:
    """The cell DM's geometry as the kernels take it: dim, h = 1 / ncell
    (float64, as the reference divides by it), ncell and the node counts
    per axis (the DMDA's sizes)."""

    def __init__(self, sizes):
        self.sizes = tuple(int(s) for s in sizes)
        self.dim = len(self.sizes)
        self.ncell = np.array([s - 1 for s in self.sizes])
        self.h = 1.0 / self.ncell
        self.nnodes = int(np.prod(self.sizes))

    def args(self):
        pad = 3 - self.dim
        return (*[float(v) for v in self.h], *(1.0,) * pad,
                *[int(v) for v in self.ncell], *(1,) * pad, *self.sizes, *(1,) * pad)


def _check(name, X, grid, vals, per_particle):
    """X's and the 1-D operands' dtype, device and layout; with
    `per_particle` every operand has X.shape[0] entries; the grid's node
    ids fit int32."""
    if not isinstance(X, torch.Tensor) or X.dtype not in _VALUES:
        raise TypeError(f"{name}: expected float64 or float32 coordinates")
    if X.dim() != 2 or X.shape[1] != grid.dim or not X.is_contiguous():
        raise ValueError(f"{name}: expected contiguous ({X.shape[0] if X.dim() else '?'}, "
                         f"{grid.dim}) coordinates, got {tuple(X.shape)}")
    for v in vals:
        if (not isinstance(v, torch.Tensor) or v.dtype != X.dtype or v.device != X.device
                or v.dim() != 1 or not v.is_contiguous()):
            raise ValueError(f"{name}: every field must be a contiguous 1-D tensor of the "
                             "coordinates' dtype and device")
        if per_particle and v.shape[0] != X.shape[0]:
            raise ValueError(f"{name}: a field of {v.shape[0]} entries for {X.shape[0]} "
                             "particles")
    if grid.nnodes > MAX_NODES:
        raise ValueError(f"{name}: {grid.nnodes} nodes; node ids are int32 (at most "
                         f"{MAX_NODES})")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {X.device}")


def cell_ids(X, grid, dtype=torch.int64):
    """Each particle's cell: floor(x / h) clamped to [0, ncell - 1] per axis
    (as the kernels' locate and the plain versions take it; the
    reference's binToCells truncates, which agrees after the clamp for
    finite x), numbered (...(i_0 * ncell_1 + i_1) * ncell_2 ...) in
    `dtype`. The numbering runs in f64, exact for integers below 2^53."""
    g = X / torch.as_tensor(grid.h, dtype=X.dtype, device=X.device)
    g.floor_().clamp_(min=torch.zeros(grid.dim, dtype=X.dtype, device=X.device),
                      max=torch.as_tensor(grid.ncell - 1, dtype=X.dtype, device=X.device))
    g = g.double()
    cid = g[:, 0]
    for ax in range(1, grid.dim):
        cid = torch.add(g[:, ax], cid, alpha=int(grid.ncell[ax]))
    return cid.to(dtype)


class CellOrder(NamedTuple):
    """The particles in cell order (PETSc's DMSwarmSortGetAccess): `perm`
    the stable permutation by cell (int32; None for the identity, a swarm
    already in cell order), `offsets` each cell's first position in it and
    the end (int32, ncell + 1), `Xs` the coordinates in that order, `sizes`
    the grid's node counts and `key` what the order was built from (see
    coords_key)."""
    perm: torch.Tensor | None
    offsets: torch.Tensor
    Xs: torch.Tensor
    sizes: tuple
    key: tuple


def coords_key(X):
    """What identifies a coordinate tensor's contents for a cached order:
    its storage, shape, strides, dtype, device and version counter (bumped
    by every in-place write)."""
    return (X.data_ptr(), tuple(X.shape), X.stride(), X.dtype, X.device, X._version)


def cell_order(X, grid):
    """The stable order of the particles by cell (:func:`cell_ids`):
    library torch on X's device, a stable sort of int32 keys and each
    cell's first position by a binary search of the sorted keys."""
    keys, perm = torch.sort(cell_ids(X, grid, torch.int32), stable=True)
    ncells = int(np.prod(grid.ncell))
    offsets = torch.searchsorted(keys, torch.arange(ncells + 1, dtype=torch.int32,
                                                    device=X.device), out_int32=True)
    return CellOrder(perm.to(torch.int32), offsets, take_rows(X, perm), grid.sizes,
                     coords_key(X))


def take_rows(X, idx):
    """X[idx] for (n, dim) coordinates. A two-column tensor goes as one
    complex number a row where its storage offset allows that view:
    index_select on (n, 2) ran at a tenth of its rate on (n, 3) on the H100
    (PERF.md)."""
    if (X.dim() == 2 and X.shape[1] == 2 and X.is_contiguous() and X.storage_offset() % 2 == 0
            and X.device.type == "cuda"):
        return torch.view_as_real(torch.view_as_complex(X).index_select(0, idx))
    return X.index_select(0, idx)


def identity_order(order, X):
    """The order of a swarm that was just put in `order`'s sequence: the
    identity permutation, the same offsets, X (the coordinates already in
    that order) itself."""
    return CellOrder(None, order.offsets, X, order.sizes, coords_key(X))


def _check_order(order, X, grid):
    ncells = int(np.prod(grid.ncell))
    if (not isinstance(order, CellOrder) or tuple(order.sizes) != grid.sizes
            or order.key != coords_key(X) or order.offsets.numel() != ncells + 1
            or order.offsets.dtype != torch.int32 or order.offsets.device != X.device
            or order.Xs.shape != X.shape or order.Xs.dtype != X.dtype
            or order.Xs.device != X.device or not order.Xs.is_contiguous()
            or (order.perm is not None and (order.perm.shape != (X.shape[0],)
                                            or order.perm.dtype != torch.int32
                                            or order.perm.device != X.device))):
        raise ValueError("cic_deposit: the cell order was not built from these coordinates "
                         "on this grid (cell_order(X, grid))")


def corners(X, grid):
    """[(nid, w)] per corner, in the reference's order and rounding (the
    plain versions' shared part)."""
    g = X / torch.as_tensor(grid.h, dtype=X.dtype, device=X.device)
    hi = torch.as_tensor(grid.ncell - 1, device=X.device)
    i0 = torch.clamp(torch.floor(g).to(torch.int32), torch.zeros_like(hi), hi).to(torch.int32)
    frac = g - i0
    out = []
    for c in np.ndindex(*([2] * grid.dim)):
        w = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
        nid = None
        for ax in range(grid.dim):
            w = w * (frac[:, ax] if c[ax] else (1.0 - frac[:, ax]))
            t = i0[:, ax] + c[ax]
            nid = t if nid is None else nid * grid.sizes[ax] + t
        out.append((nid.long(), w))
    return out


def cic_deposit_plain(X, grid, fields, wsum=False):
    """(len(fields) + wsum, nnodes): each field's corner loop of index_add_."""
    acc = torch.zeros((len(fields) + int(wsum), grid.nnodes), dtype=X.dtype, device=X.device)
    for nid, w in corners(X, grid):
        for k, f in enumerate(fields):
            acc[k].index_add_(0, nid, w * f)
        if wsum:
            acc[len(fields)].index_add_(0, nid, w)
    return acc


def cic_deposit(X, grid, fields, wsum=False, order=None, _capacity=-1):
    """W1: the nodal sums of w * f for each field of `fields` (1-D, one
    entry a particle) and with `wsum` the weights' sum, as the rows of one
    (len(fields) + wsum, nnodes) tensor; one launch for up to MAX_FIELDS
    fields. `order` is X's cell_order on this grid (a DMSwarm keeps it with
    its coordinates); without it a CUDA call builds it first. A launch is
    three device launches (the staged tiles, the dense tiles' list, the
    dense tiles: csrc/swarm_cic.cu), one count. `_capacity` (for tests)
    caps the particles a block stages and a dense round holds: a tile whose
    cells hold more is a dense one (0: every tile with a particle, streamed
    a particle a node a round); -1 leaves both to the kernel."""
    fields = list(fields)
    _check("cic_deposit", X, grid, fields, per_particle=True)
    if order is not None:
        _check_order(order, X, grid)
    if X.device.type == "cpu":
        return cic_deposit_plain(X, grid, fields, wsum)
    n = X.shape[0]
    if not n:
        return torch.zeros((len(fields) + int(wsum), grid.nnodes), dtype=X.dtype,
                           device=X.device)
    if n > 2**31 - 1:
        raise ValueError(f"cic_deposit: {n} particles; the cell order's positions are int32")
    if order is None:
        order = cell_order(X, grid)
    # every node is written by the kernel (0 where no particle lands)
    acc = torch.empty((len(fields) + int(wsum), grid.nnodes), dtype=X.dtype, device=X.device)
    perm = order.perm.data_ptr() if order.perm is not None else None
    tile = W1_TILES[grid.dim][order.perm is None]
    tiles = int(np.prod([-(-s // e) for s, e in zip(grid.sizes, tile)]))
    scratch = torch.empty(2 * tiles + 1, dtype=torch.int32, device=X.device)
    for a in range(0, max(len(fields), 1), MAX_FIELDS):
        chunk = fields[a:a + MAX_FIELDS]
        last = a + MAX_FIELDS >= len(fields)
        # the chunk's rows, then (in the last chunk) the weight sum's
        rows = acc[a:a + len(chunk) + int(wsum and last)] if last else acc[a:a + len(chunk)]
        ptrs = [f.data_ptr() for f in chunk] + [None] * (MAX_FIELDS - len(chunk))
        ws = int(wsum and last)
        cuda_build.launch(LAUNCHES, "cic_deposit", X, order.Xs.data_ptr(), perm,
                          order.offsets.data_ptr(), n, grid.dim, *ptrs, len(chunk), ws,
                          rows.data_ptr(), grid.nnodes, *grid.args(), int(_capacity),
                          scratch.data_ptr())
    return acc


def cic_interp_plain(X, grid, v):
    out = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    for nid, w in corners(X, grid):
        out = out + w * v[nid]
    return out


def cic_interp(X, grid, v):
    """W2: out[p] = sum over p's corners of w * v[nid], in the reference's
    corner order. In 2-D the launch first fills a table of corner pairs
    (v[i], v[i + 1]) (nnodes x 2 entries of scratch) from which the
    interpolation reads each pair in one load: two device launches, one
    count."""
    _check("cic_interp", X, grid, [v], per_particle=False)
    if v.numel() < grid.nnodes:
        raise ValueError(f"cic_interp: {v.numel()} nodal values for {grid.nnodes} nodes")
    if X.device.type == "cpu":
        return cic_interp_plain(X, grid, v)
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    if X.shape[0]:
        pairs = (torch.empty((grid.nnodes, 2), dtype=X.dtype, device=X.device)
                 if grid.dim == 2 else None)
        cuda_build.launch(LAUNCHES, "cic_interp", X, X.data_ptr(), X.shape[0], grid.dim,
                          v.data_ptr(), None if pairs is None else pairs.data_ptr(),
                          out.data_ptr(), *grid.args())
    return out
