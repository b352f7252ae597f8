"""DMDA: the structured-grid manager (1-3 axes, dof components per node).

Counterpart of ``petsc_tpu/dm/da.py`` (reference src/dm/impls/da:
DMDACreate2d da2.c:810, box or star stencil of width s, dof, boundary
types; DMCreateMatrix_DA fdda.c; the Q1 interpolation of dainterp.c:39-605
that PCMG uses; DMDAGetCorners). A DMDA vector is a device ``Vec`` in the
natural ordering, x fastest, the components innermost:
idx = ((k ny + j) nx + i) dof + c. One device, so the local (ghosted)
form is the global vector itself. Grid-aware set-up is vectorised numpy
over index arrays, not a loop over points.

``createMatrix`` declares the grid before any assembly: a scalar field's
matrix its (nz, ny, nx) grid (``setStencilGrid``), so that its first
device build already takes the ``aij_dnd`` layout (one plane per stencil
offset, product V1) whether it is assembled by values, CSR or COO; a field
of dof > 1 components its block size, so that it takes ``aij_bsr`` (B1).
``createInterpolation`` gives the gather-free ``MatInterpQ1`` (Q1P/Q1R on
the card) between factor-2 grids without periodic axes, else the
assembled Kronecker product of the 1-D interpolations (S2).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..mat.aij import MatAIJ
from ..sys.error import Error
from ..vec.vec import Vec
from .dm import DM


class DMDA(DM):
    def __init__(self, comm=None, **kw):
        super().__init__(comm, **kw)
        self.dim = None
        self.sizes = None            # (nx,) / (nx, ny) / (nx, ny, nz)
        self.dof = 1
        self.stencil_width = 1
        self.stencil_type = "star"   # star | box
        self.boundary = ("none",) * 3
        self._refine_factor = 2

    # ---- creation (da1.c / da2.c / da3.c) ----

    @classmethod
    def create(cls, dim=None, sizes=None, dof=1, stencil_width=1,
               stencil_type="star", boundary_type=None, comm=None,
               setup=True):
        da = cls(comm)
        sizes = tuple(int(s) for s in np.atleast_1d(sizes))
        da.dim = dim if dim is not None else len(sizes)
        da.sizes = sizes
        da.dof = int(dof)
        da.stencil_width = stencil_width
        da.stencil_type = stencil_type
        if boundary_type is not None:
            bt = tuple(boundary_type) if isinstance(boundary_type, (list, tuple)) \
                else (boundary_type,) * da.dim
            da.boundary = tuple(bt) + ("none",) * (3 - len(bt))
        if setup:
            da.setUp()
        return da

    def setUp(self):
        if len(self.sizes) != self.dim:
            raise Error(f"DMDA: {len(self.sizes)} sizes for dim {self.dim}")
        return self

    def setFromOptions(self):
        """-da_grid_x|y|z and -da_refine (da.py:63-78)."""
        for ax, name in zip(range(self.dim), ("x", "y", "z")):
            v = self.opt("get_int", f"da_grid_{name}", None)
            if v:
                s = list(self.sizes)
                s[ax] = v
                self.sizes = tuple(s)
        n = self.opt("get_int", "da_refine", None)
        if n:
            da = self
            for _ in range(n):
                da = da.refine()
            self.sizes = da.sizes
        return self

    # ---- geometry ----

    @property
    def N(self):
        return int(np.prod(self.sizes)) * self.dof

    def getCorners(self):
        """(starts, sizes) of the owned region: the whole grid on one device."""
        return (0,) * self.dim, self.sizes

    def getGhostCorners(self):
        return (0,) * self.dim, self.sizes

    def getInfo(self):
        return {"dim": self.dim, "sizes": self.sizes, "dof": self.dof,
                "stencil_width": self.stencil_width,
                "stencil_type": self.stencil_type, "boundary": self.boundary}

    def dof_index(self, i, j=None, k=None, c=0):
        """Flat dof index of node (i, j, k), component c."""
        idx = np.asarray(i)
        if self.dim >= 2:
            idx = idx + np.asarray(j) * self.sizes[0]
        if self.dim >= 3:
            idx = idx + np.asarray(k) * self.sizes[0] * self.sizes[1]
        return idx * self.dof + c

    # ---- vectors ----

    def createGlobalVector(self) -> Vec:
        v = Vec(self.comm)
        v.setSizes(self.N)
        v.setUp()
        v._dm = self
        return v

    createLocalVector = createGlobalVector  # one device: the same vector

    def getVecArray(self, vec: Vec):
        """A host numpy copy shaped (nz, ny, nx[, dof]) for grid-indexed
        set-up (the DMDAVecGetArray model); setVecArray stores it back."""
        shape = tuple(self.sizes[::-1])
        if self.dof > 1:
            shape = shape + (self.dof,)
        return np.asarray(vec.getArray()).reshape(shape).copy()

    def setVecArray(self, vec: Vec, arr):
        vec.setArray(np.asarray(arr).reshape(-1))

    def globalToLocal(self, g, l=None, **kw):
        if l is not None:
            l.array = g.array.clone()
            return l
        return g

    def localToGlobal(self, l, g=None, **kw):
        if g is not None:
            g.array = l.array.clone()
            return g
        return l

    # ---- matrix (fdda.c) ----

    def createMatrix(self, preallocate_pattern=False) -> MatAIJ:
        """An empty MatAIJ of the DMDA's size that knows its grid before any
        assembly (da.py:144-154): the grid for a scalar field, the block
        size dof otherwise."""
        A = MatAIJ(self.comm)
        A.setSizes((self.N, self.N), bs=self.dof)
        if self.dof == 1:
            A.setStencilGrid(tuple(self.sizes[::-1]))
        A._dm = self
        if preallocate_pattern:
            self.preallocateStencilPattern(A)
        return A

    def preallocateStencilPattern(self, A: MatAIJ):
        """Fill A with the stencil's nonzero pattern, all zeros (the
        DMCreateMatrix_DA preallocation, fdda.c; da.py:156-185)."""
        import scipy.sparse as sp
        xyz = self.node_coords()
        cols_all, rows_all = [], []
        for off in self.stencil_offsets():
            shifted = xyz[:, : self.dim] + np.asarray(off)
            ok = np.ones(len(xyz), dtype=bool)
            for ax in range(self.dim):
                if self.boundary[ax] == "periodic":
                    shifted[:, ax] %= self.sizes[ax]
                else:
                    ok &= (shifted[:, ax] >= 0) & (shifted[:, ax] < self.sizes[ax])
            src = self.dof_index(*(xyz[ok, ax] for ax in range(self.dim)))
            dst = self.dof_index(*(shifted[ok, ax] for ax in range(self.dim)))
            for cs in range(self.dof):
                for cd in range(self.dof):
                    rows_all.append(src + cs if self.dof > 1 else src)
                    cols_all.append(dst + cd if self.dof > 1 else dst)
        rows = np.concatenate(rows_all)
        cols = np.concatenate(cols_all)
        S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(self.N, self.N))
        S.sum_duplicates()
        A.setValuesCSR(S.indptr, S.indices, np.zeros(S.nnz))
        A.assemble()
        return A

    def stencil_offsets(self):
        """The stencil's node offsets (dim-tuples, x first)."""
        rng = range(-self.stencil_width, self.stencil_width + 1)
        if self.dim == 1:
            offs = [(dx,) for dx in rng]
        elif self.dim == 2:
            offs = [(dx, dy) for dy in rng for dx in rng]
        else:
            offs = [(dx, dy, dz) for dz in rng for dy in rng for dx in rng]
        if self.stencil_type == "star":
            offs = [o for o in offs if sum(v != 0 for v in o) <= 1]
        return offs

    def interior_mask(self, width=1):
        """Boolean mask over the flat nodes: those at least `width` from
        every non-periodic boundary."""
        flat = np.ones(int(np.prod(self.sizes)), dtype=bool)
        for ax, g in enumerate(self._axis_coords()):
            if self.boundary[ax] == "periodic":
                continue
            flat &= (g >= width) & (g < self.sizes[ax] - width)
        return flat

    def node_coords(self):
        """(nnode, dim) integer node coordinates, columns x, y, z."""
        return np.stack(self._axis_coords(), axis=1)

    def _axis_coords(self):
        """Each axis's coordinate of every flat node (x fastest), as the
        reference's transposed meshgrid (da.py:198-224) gives them."""
        grids = np.meshgrid(*[np.arange(s) for s in self.sizes], indexing="ij")
        return [g.transpose(*range(self.dim - 1, -1, -1)).reshape(-1) for g in grids]

    # ---- hierarchy (dainterp.c / DMCoarsen) ----

    def _like(self, sizes):
        da = DMDA.create(self.dim, tuple(sizes), self.dof, self.stencil_width,
                         self.stencil_type, comm=self.comm)
        da.boundary = self.boundary
        da._compute_operators = self._compute_operators
        da._compute_rhs = self._compute_rhs
        da.app_ctx = self.app_ctx
        return da

    def coarsen(self):
        cs = []
        for ax, s in enumerate(self.sizes):
            if self.boundary[ax] == "periodic":
                if s % self._refine_factor:
                    raise Error(f"DMDA: cannot coarsen periodic size {s}")
                cs.append(s // self._refine_factor)
            else:
                if (s - 1) % self._refine_factor:
                    raise Error(f"DMDA: cannot coarsen size {s} "
                                f"(need s = {self._refine_factor}*sc - 1)")
                cs.append((s - 1) // self._refine_factor + 1)
        return self._like(cs)

    def refine(self):
        rs = []
        for ax, s in enumerate(self.sizes):
            if self.boundary[ax] == "periodic":
                rs.append(s * self._refine_factor)
            else:
                rs.append(self._refine_factor * (s - 1) + 1)
        return self._like(rs)

    def _interp_1d(self, nf, nc, periodic):
        """1-D vertex-centred Q1 prolongation (dainterp.c:39 DA_Q1)."""
        import scipy.sparse as sp
        rows, cols, vals = [], [], []
        if periodic:
            ratio = nf // nc
            for fi in range(nf):
                x = fi / ratio
                j0 = int(np.floor(x))
                w1 = x - j0
                if w1 == 0:
                    rows.append(fi)
                    cols.append(j0 % nc)
                    vals.append(1.0)
                else:
                    rows += [fi, fi]
                    cols += [j0 % nc, (j0 + 1) % nc]
                    vals += [1 - w1, w1]
        else:
            for fi in range(nf):
                x = fi * (nc - 1) / (nf - 1)
                j0 = min(int(np.floor(x)), nc - 2)
                w1 = x - j0
                if w1 < 1e-14:
                    rows.append(fi)
                    cols.append(j0)
                    vals.append(1.0)
                elif w1 > 1 - 1e-14:
                    rows.append(fi)
                    cols.append(j0 + 1)
                    vals.append(1.0)
                else:
                    rows += [fi, fi]
                    cols += [j0, j0 + 1]
                    vals += [1 - w1, w1]
        return sp.csr_matrix((vals, (rows, cols)), shape=(nf, nc))

    def createInjection(self, coarse: "DMDA"):
        """State injection fine -> coarse (DMCreateInjection): coarse node
        (i, j, k) takes the value at fine node (2i, 2j, 2k). A callable over
        flat tensors (on their device), with its numpy form as ``.np``."""
        fshape = tuple(self.sizes[::-1])
        sl = tuple(slice(0, None, 2) for _ in fshape)
        nf = int(np.prod(fshape))

        def inject(xf):
            t = xf if isinstance(xf, torch.Tensor) else \
                torch.as_tensor(np.asarray(xf), dtype=config.real_dtype(), device=config.device())
            return t[:nf].reshape(fshape)[sl].reshape(-1)

        def inject_np(xf):
            return np.asarray(xf)[:nf].reshape(fshape)[sl].reshape(-1)

        inject.np = inject_np
        return inject

    def createInterpolation(self, coarse: "DMDA"):
        """The Q1 prolongation coarse -> self (da.py:312-333): MatInterpQ1
        between factor-2 grids with no periodic axis, else the assembled
        Kronecker product of the 1-D interpolations (and of I_dof)."""
        if (all(b == "none" for b in self.boundary[: self.dim])
                and all(self.sizes[ax] == 2 * coarse.sizes[ax] - 1
                        for ax in range(self.dim))):
            from .interp import MatInterpQ1
            Pq = MatInterpQ1(tuple(self.sizes[::-1]), tuple(coarse.sizes[::-1]),
                             comm=self.comm, dof=self.dof)
            if Pq.comm.nshards == 1:
                return Pq
            # over several ranks the vertex-centred grids do not split into
            # slabs (nf0 = 2 nc0 - 1): the assembled Q1, distributed
            return MatAIJ.from_scipy(Pq.to_scipy(), comm=self.comm)
        import scipy.sparse as sp
        P = None
        # the slowest axis first: z, y, x
        for ax in range(self.dim - 1, -1, -1):
            p1 = self._interp_1d(self.sizes[ax], coarse.sizes[ax],
                                 self.boundary[ax] == "periodic")
            P = p1 if P is None else sp.kron(P, p1, format="csr")
        if self.dof > 1:
            P = sp.kron(P, sp.eye(self.dof), format="csr")
        return MatAIJ.from_scipy(P.tocsr(), comm=self.comm)

    def view(self, viewer=None):
        names = "MNP"
        dims = " ".join(f"{names[i]}={self.sizes[i]}" for i in range(self.dim))
        print(f"DMDA Object: dim={self.dim} {dims} dof={self.dof} "
              f"stencil width={self.stencil_width} type={self.stencil_type}")
