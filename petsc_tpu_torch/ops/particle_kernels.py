"""Hand-written Hopper kernels of DMSwarm's particle-mesh coupling, beside
their plain versions.

The JAX package computes both in jnp (``petsc_tpu/dm/swarm.py:166-254``),
left to XLA on the TPU: a cloud-in-cell scatter-add for the deposit and the
adjoint gather for the interpolation. Here each is a CUDA C++ kernel for
sm_90a (``petsc_tpu_torch/csrc/swarm_cic.cu``, built and loaded by
:mod:`.cuda_build`):

  cic_deposit  W1  acc[k][nid] += w * f_k[p], and acc[nf][nid] += w with
                   ``wsum`` (depositSum, projectFields), one launch for up
                   to four fields
  cic_interp   W2  out[p] = sum_c w_c * v[nid_c] (interpolateToParticles)

For particle p: its cell i0 = clip(floor(x / h), 0, ncell - 1) and
fractions t = x / h - i0 per axis; for each of the 2^dim corners c (the
last axis fastest) the weight prod_ax (c_ax ? t_ax : 1 - t_ax) in axis
order and the node (...((i0_0 + c_0) * sizes_1 + i0_1 + c_1) ...), the
reference's numbering. W1 adds with atomics, so it sums in another order
than its plain version (the reference's corner loop with ``index_add_``)
and is held to it at 1e-13 of sum |w f| per node in f64 (1e-5 in f32);
W2 rounds each step as the plain version does and equals it bit for bit.
Every wrapper checks its operands, launches on the current stream without
synchronising and adds one to ``LAUNCHES[name]``. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

# launches of each kernel since the last reset_launches()
LAUNCHES = {"cic_deposit": 0, "cic_interp": 0}

MAX_FIELDS = 4          # fields one W1 launch deposits (kMaxFields in swarm_cic.cu)
MAX_NODES = 2**31 - 1   # the kernels and the plain versions number nodes in int32
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


def cic_deposit(X, grid, fields, wsum=False):
    """W1: the nodal sums of w * f for each field of `fields` (1-D, one
    entry a particle) and with `wsum` the weights' sum, as the rows of one
    (len(fields) + wsum, nnodes) tensor; one launch for up to MAX_FIELDS
    fields."""
    fields = list(fields)
    _check("cic_deposit", X, grid, fields, per_particle=True)
    if X.device.type == "cpu":
        return cic_deposit_plain(X, grid, fields, wsum)
    acc = torch.zeros((len(fields) + int(wsum), grid.nnodes), dtype=X.dtype, device=X.device)
    n = X.shape[0]
    for a in range(0, max(len(fields), 1), MAX_FIELDS):
        chunk = fields[a:a + MAX_FIELDS]
        last = a + MAX_FIELDS >= len(fields)
        # the chunk's rows, then (in the last chunk) the weight sum's
        rows = acc[a:a + len(chunk) + int(wsum and last)] if last else acc[a:a + len(chunk)]
        if n:
            ptrs = [f.data_ptr() for f in chunk] + [None] * (MAX_FIELDS - len(chunk))
            cuda_build.launch(LAUNCHES, "cic_deposit", X, X.data_ptr(), n, grid.dim, *ptrs,
                              len(chunk), int(wsum and last), rows.data_ptr(), grid.nnodes,
                              *grid.args())
    return acc


def cic_interp_plain(X, grid, v):
    out = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    for nid, w in corners(X, grid):
        out = out + w * v[nid]
    return out


def cic_interp(X, grid, v):
    """W2: out[p] = sum over p's corners of w * v[nid], in the reference's
    corner order."""
    _check("cic_interp", X, grid, [v], per_particle=False)
    if v.numel() < grid.nnodes:
        raise ValueError(f"cic_interp: {v.numel()} nodal values for {grid.nnodes} nodes")
    if X.device.type == "cpu":
        return cic_interp_plain(X, grid, v)
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    if X.shape[0]:
        cuda_build.launch(LAUNCHES, "cic_interp", X, X.data_ptr(), X.shape[0], grid.dim,
                          v.data_ptr(), out.data_ptr(), *grid.args())
    return out
