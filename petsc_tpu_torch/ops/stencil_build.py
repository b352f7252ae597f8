"""Device-side construction of constant-coefficient grid-stencil operators.

Counterpart of ``petsc_tpu/ops/stencil_build.py`` (the role of DMDA
matrix assembly, reference src/dm/impls/da/fdda.c, for the constant-
coefficient case). A constant stencil is stored as scalars in its meta
and a scalar diagonal: nothing of size N is built at all. With
``variable=True`` the same operator is stored as boundary-masked
coefficient planes instead, for the variable-coefficient product V1.

Boundary convention: an offset's coefficient is zero wherever the
neighbour falls outside the grid (Dirichlet row truncation — the pattern
``bench_kspsolve.c`` and ex45 produce).
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from .. import config
from ..mat.mat import Mat


def stencil_offsets(ndim: int, kind: str):
    """Offsets for 'star' (2*ndim+1-point) or 'box' (3^ndim-point)."""
    if kind == "star":
        offs = [(0,) * ndim]
        for ax in range(ndim):
            for s in (-1, 1):
                o = [0] * ndim
                o[ax] = s
                offs.append(tuple(o))
        return offs
    if kind == "box":
        return list(product((-1, 0, 1), repeat=ndim))
    raise ValueError(kind)


def _valid_mask(shape, off, dtype, device):
    """1 where the `off` neighbour of a point lies inside the grid, else 0."""
    m = torch.ones(shape, dtype=dtype, device=device)
    for ax, o in enumerate(off):
        if o:
            idx = torch.arange(shape[ax], device=device)
            ok = ((idx + o >= 0) & (idx + o < shape[ax])).to(dtype)
            view = [1] * len(shape)
            view[ax] = shape[ax]
            m = m * ok.reshape(view)
    return m


def build_dnd(shape, offsets=None, diag_coef=None, off_coef=-1.0,
              kind="box", dtype=None, variable=False):
    """(meta, data) for the `aij_dnd` binder, on the device of ``config.init``.

    diag_coef default: number of off-diagonal offsets (26 for 3-D box,
    2*ndim for star) — the diagonally-dominant Poisson-type operator of
    bench_kspsolve.c (27-point, diag 26) / ex45 (7-point, diag 6).

    The meta tuple is the reference's: ("aij_dnd", shape, offsets, lpad,
    rpad, N, per-offset constant coefficients).

    variable=True stores the boundary-masked per-offset coefficient
    PLANES (K, *shape) and a diagonal vector instead, under the
    reference's 6-field meta with no constants: the same operator through
    the variable-coefficient product (real variable-coefficient operators
    arrive through MatAIJ.setStencilGrid)."""
    shape = tuple(int(s) for s in shape)
    dt = dtype or config.real_dtype()
    if offsets is None:
        offsets = [o for o in stencil_offsets(len(shape), kind) if any(o)]
    offsets = [tuple(int(v) for v in o) for o in offsets]
    if (0,) * len(shape) not in offsets:
        offsets = [(0,) * len(shape)] + offsets
    if diag_coef is None:
        diag_coef = float(len(offsets) - 1)

    uniq = np.asarray(offsets)
    lpad = tuple(int(max(0, -uniq[:, ax].min())) for ax in range(len(shape)))
    rpad = tuple(int(max(0, uniq[:, ax].max())) for ax in range(len(shape)))
    dev = config.device()
    if variable:
        planes = torch.stack([
            (diag_coef if not any(o) else off_coef) * _valid_mask(shape, o, dt, dev)
            for o in offsets])
        meta = ("aij_dnd", shape, tuple(offsets), lpad, rpad, int(np.prod(shape)))
        return meta, {"coef": planes,
                      "diag": torch.full((int(np.prod(shape)),), float(diag_coef), dtype=dt,
                                         device=dev)}
    cvals = tuple(float(diag_coef) if not any(o) else float(off_coef)
                  for o in offsets)
    coef = torch.zeros((0,) + shape, dtype=dt, device=dev)
    meta = ("aij_dnd", shape, tuple(offsets), lpad, rpad,
            int(np.prod(shape)), cvals)
    # the diagonal of a constant stencil is one scalar; consumers (the
    # Jacobi inverse) broadcast it, and getDiagonal expands on demand
    return meta, {"coef": coef,
                  "diag": torch.tensor(float(diag_coef), dtype=dt, device=dev)}


def _host(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)) \
        .astype(np.float64)


def dnd_to_csr(meta, data):
    """A (small) dnd operator as a host CSR in float64 (the reference's
    pc/gamg_device.py:360-394): the one download of the GAMG device head,
    which hands the coarse tail to the aggregation loop, and a stencil
    Mat's to_scipy."""
    import scipy.sparse as sp

    shape = tuple(int(s) for s in meta[1])
    offs = [tuple(int(v) for v in o) for o in meta[2]]
    N = int(np.prod(shape))
    cvals = meta[6] if len(meta) > 6 else (None,) * len(offs)
    coef = _host(data["coef"])
    nd = len(shape)
    idx = np.indices(shape).reshape(nd, -1)
    strides = np.array([int(np.prod(shape[d + 1:])) for d in range(nd)])
    rows_l, cols_l, vals_l = [], [], []
    ci = 0
    for k, o in enumerate(offs):
        tgt = idx + np.asarray(o)[:, None]
        ok = np.ones(N, dtype=bool)
        for d in range(nd):
            ok &= (tgt[d] >= 0) & (tgt[d] < shape[d])
        if cvals[k] is None:
            v = coef[ci].reshape(-1)
            ci += 1
        else:
            v = np.full(N, float(cvals[k]))
        keep = ok & (v != 0)
        rows_l.append(np.nonzero(keep)[0])
        cols_l.append((strides @ tgt)[keep])
        vals_l.append(v[keep])
    return sp.csr_matrix((np.concatenate(vals_l),
                          (np.concatenate(rows_l), np.concatenate(cols_l))), shape=(N, N))


def as_mat(meta, data, comm=None):
    """Wrap a (meta, data) stencil operator as a Mat (its binder,
    ``mat/aij.py``, is registered by the package's ``__init__``)."""
    class _StencilMat(Mat):
        @property
        def meta(self):
            return self._meta_val

        def device_data(self):
            return self._data_val

        def nnz(self):
            return nnz_of(self._shape_val, self._offsets_val)

        def to_scipy(self):
            # the host CSR (a coarsest structured level's LU needs it; the
            # reference's stencil Mat has none and fails there)
            return dnd_to_csr(self._meta_val, self._data_val)

    M = _StencilMat(comm)
    N = int(meta[5])
    M.setSizes((N, N))
    M._meta_val = meta
    M._data_val = data
    M._shape_val = meta[1]
    M._offsets_val = meta[2]
    M._assembled = True
    # the declared grid sends PCGAMG through the structured head
    M._grid_shape = tuple(int(v) for v in meta[1])
    return M


def nnz_of(shape, offsets):
    """Exact nonzero count of the masked stencil (for nnz/s metrics)."""
    shape = np.asarray(shape)
    total = 0
    for off in offsets:
        rows = 1
        for ax, o in enumerate(off):
            rows *= shape[ax] - abs(int(o))
        total += rows
    return int(total)


def poisson3d_27pt(n):
    """Host reference: the 3-D 27-point operator (every off-diagonal -1,
    diagonal 26, Dirichlet row truncation) on an n^3 grid as a scipy CSR
    matrix, assembled independently of the stencil path (the same assembly
    as ``bench.py:_poisson3d_27pt``)."""
    import scipy.sparse as sp
    offs = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]
    N = n ** 3
    idx = np.arange(N)
    z, r = divmod(idx, n * n)
    y, x = divmod(r, n)
    rows, cols, vals = [idx], [idx], [np.full(N, 26.0)]
    for dx, dy, dz in offs:
        xx, yy, zz = x + dx, y + dy, z + dz
        ok = (xx >= 0) & (xx < n) & (yy >= 0) & (yy < n) & (zz >= 0) & (zz < n)
        rows.append(idx[ok])
        cols.append((zz * n * n + yy * n + xx)[ok])
        vals.append(np.full(ok.sum(), -1.0))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N, N))


def stencil7_coo(nz, ny, nx, jitter=True):
    """COO triplets (i, j, v) of the atmosmodd-class operator of BASELINE
    config 2, the port's copy of ``examples/bench_spmv.py:69-90``
    ``stencil7``: a 7-point stencil on an nz x ny x nx grid (x fastest),
    diagonal 6.5 and off-diagonals -1, each scaled by
    1 + 0.1 ((13 r + dz + dy + dx) mod 7) / 7 when `jitter` (so the
    operator is not symmetric), neighbours outside the grid dropped. The
    triplets come offset by offset (the diagonal first), as the
    reference concatenates them."""
    n = nz * ny * nx
    r = np.arange(n, dtype=np.int64)
    z, rem = r // (ny * nx), r % (ny * nx)
    yy, xx = rem // nx, rem % nx
    rows, cols, vals = [], [], []
    for (dz, dy, dx) in ((0, 0, 0), (0, 0, -1), (0, 0, 1), (0, -1, 0),
                         (0, 1, 0), (-1, 0, 0), (1, 0, 0)):
        ok = ((z + dz >= 0) & (z + dz < nz) & (yy + dy >= 0)
              & (yy + dy < ny) & (xx + dx >= 0) & (xx + dx < nx))
        c = r + (dz * ny * nx + dy * nx + dx)
        v = np.full(n, 6.5) if (dz, dy, dx) == (0, 0, 0) else np.full(n, -1.0)
        if jitter:
            v = v * (1.0 + 0.1 * ((r * 13 + dz + dy + dx) % 7) / 7.0)
        rows.append(r[ok])
        cols.append(c[ok])
        vals.append(v[ok])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


# Q1 bilinear element Laplacian on a unit square element, nodes (SW, SE, NW, NE)
Q1_KE = np.array([[4.0, -1.0, -1.0, -2.0],
                  [-1.0, 4.0, -2.0, -1.0],
                  [-1.0, -2.0, 4.0, -1.0],
                  [-2.0, -1.0, -1.0, 4.0]]) / 6.0


def matis_poisson(ne, nsub):
    """Q1 Poisson on ne x ne elements of the unit square, the Dirichlet
    boundary eliminated, cut into nsub x nsub subdomains of (ne / nsub)^2
    elements with their local Neumann matrices: the unassembled MATIS input
    of PETSc's src/ksp/ksp/tutorials/ex59.c class. Each subdomain's dofs are
    numbered in order of first appearance over its elements (row by row)
    and their nodes (SW, SE, NW, NE), as the reference's test function
    numbers them. Returns (local matrices, local-to-global maps, global
    size), numpy arrays."""
    nn = ne + 1
    inner = np.full(nn * nn, -1, dtype=np.int64)
    ii, jj = np.meshgrid(np.arange(1, ne), np.arange(1, ne), indexing="xy")
    inner[(jj * nn + ii).ravel()] = np.arange((ne - 1) ** 2)
    e = ne // nsub
    ei, ej = np.meshgrid(np.arange(e), np.arange(e), indexing="xy")
    ei, ej = ei.ravel(), ej.ravel()
    mats, maps = [], []
    for sy in range(nsub):
        for sx in range(nsub):
            x0, y0 = sx * e + ei, sy * e + ej
            nodes = np.stack([y0 * nn + x0, y0 * nn + x0 + 1, (y0 + 1) * nn + x0,
                              (y0 + 1) * nn + x0 + 1], axis=1)       # (elements, 4)
            glob = inner[nodes]
            flat = glob.ravel()
            keep = flat >= 0
            uniq, first = np.unique(flat[keep], return_index=True)
            order = uniq[np.argsort(first)]                          # first appearance
            loc = np.full((ne - 1) ** 2, -1, dtype=np.int64)
            loc[order] = np.arange(len(order))
            lg = np.where(glob >= 0, loc[np.maximum(glob, 0)], -1)
            a = np.repeat(lg, 4, axis=1).ravel()
            b = np.tile(lg, (1, 4)).ravel()
            v = np.tile(Q1_KE.ravel(), len(ei))
            ok = (a >= 0) & (b >= 0)
            k = len(order)
            A = np.bincount(a[ok] * k + b[ok], weights=v[ok], minlength=k * k).reshape(k, k)
            mats.append(A)
            maps.append(order)
    return mats, maps, (ne - 1) ** 2
