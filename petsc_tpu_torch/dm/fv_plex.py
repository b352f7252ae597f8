"""Cell-centered finite volumes on unstructured plex meshes.

Counterpart of ``petsc_tpu/dm/fv_plex.py``. Behavioral reference:
src/dm/impls/plex/plexfvm.c (DMPlexComputeResidual_Internal's FVM path:
face geometry, Riemann callbacks with (uL, uR, n) -> flux, ghost boundary
cells) and src/dm/dt/fv/interface/fv.c (PetscFVUpwind /
PetscFVLeastSquares slope reconstruction + PetscLimiter).

The face loop is flattened into static gather/scatter tables built once
on the host (vectorised, with the reference's face order and neighbour
order) and moved to the device once per device: every cell-to-face
gather (u[cL], u[cR], the least-squares stencil u[nb], the gradient and
the limiter's envelope at each face) is one K8 launch
(ops/gather_kernels.py), the Riemann evaluation over all faces and the
small per-cell and per-face products are elementwise torch, and the two
scatters back to the cells are X1
(ops/pc_kernels.py): the face fluxes by one signed table (the left
cells' entries first, then the interior right cells', the reference's
two ``.at[].add`` in their order, so the plain version gives its sums),
and Barth-Jespersen's per-cell minimum over the faces by X1's min mode on
one table (the reference's two ``.at[].min``; order-free, equal bits).

Second order reconstructs per-cell least-squares gradients (the
PetscFVLeastSquares role, normal equations precomputed on host as a
dense per-cell pseudo-inverse over a fixed neighbor stencil) limited by
Barth-Jespersen (the TVD cell limiter plexfvm.c applies by default).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.gather_kernels import gather
from ..ops.pc_kernels import dst_scatter, scatter_table


_FACETS = {
    # local facet vertex ids per cell shape (simplex: opposite-vertex
    # convention; quad: edges in circulation order)
    (2, 3): [(1, 2), (2, 0), (0, 1)],
    (2, 4): [(0, 1), (1, 2), (2, 3), (3, 0)],
    (3, 4): [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)],
}


def _unique_rows(key, nv):
    """np.unique(key, axis=0, return_index, return_inverse, return_counts)
    for rows of vertex ids below nv: through one int64 code per row where
    it fits (the same lexicographic order), else the row-wise unique."""
    k = key.shape[1]
    if float(nv) ** k < 2.0 ** 62:
        code = np.zeros(len(key), dtype=np.int64)
        for j in range(k):
            code = code * nv + key[:, j]
        _, first, inv, counts = np.unique(code, return_index=True, return_inverse=True,
                                          return_counts=True)
        return key[first], first, inv.reshape(-1), counts
    uniq, first, inv, counts = np.unique(key, axis=0, return_index=True,
                                         return_inverse=True, return_counts=True)
    return uniq, first, inv.reshape(-1), counts


def face_geometry(plex):
    """Unique faces with (left cell, right cell|-1), outward-from-left
    unit normals, areas, centroids, and cell volumes/centroids
    (DMPlexComputeGeometryFVM's tables, vectorized host numpy)."""
    import math
    cells = np.asarray(plex.cells)
    coords = np.asarray(plex.coords)
    dim = plex.dim
    nv = cells.shape[1]
    try:
        facets = _FACETS[(dim, nv)]
    except KeyError:
        raise ValueError(f"FVPlex: unsupported cell ({dim}-d, {nv} verts)")
    nc = len(cells)
    # cell centroids + volumes
    ccent = coords[cells].mean(axis=1)
    if (dim, nv) in ((2, 3), (3, 4)):
        v = coords[cells]
        J = v[:, 1:, :] - v[:, :1, :]
        vol = np.abs(np.linalg.det(J)) / math.factorial(dim)
    else:  # quad: split into two triangles (2-D shoelace per triangle)
        v = coords[cells]

        def cross2(a, b):
            return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]

        a1 = cross2(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        a2 = cross2(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0])
        vol = 0.5 * (np.abs(a1) + np.abs(a2))
    # face table: sorted vertex tuple -> (first cell, second cell)
    fverts = np.concatenate([cells[:, f] for f in facets])  # (nc*nf, k)
    fcell = np.tile(np.arange(nc), len(facets))
    key = np.sort(fverts, axis=1)
    uniq, first, inv, counts = _unique_rows(key, int(coords.shape[0]))
    nf = len(uniq)
    cL = np.full(nf, -1, dtype=np.int64)
    cR = np.full(nf, -1, dtype=np.int64)
    # a face's first entry (in entry order) is its left cell, a later one
    # its right cell (the reference's loop over the stable order)
    order = np.argsort(inv, kind="stable")
    sinv = inv[order]
    lead = np.ones(len(order), dtype=bool)
    lead[1:] = sinv[1:] != sinv[:-1]
    cL[sinv[lead]] = fcell[order[lead]]
    cR[sinv[~lead]] = fcell[order[~lead]]
    # geometry from the LEFT cell's (oriented) facet
    lv = fverts[first]                                   # (nf, k)
    if dim == 2:
        e = coords[lv[:, 1]] - coords[lv[:, 0]]
        normal = np.stack([e[:, 1], -e[:, 0]], axis=1)
        area = np.linalg.norm(normal, axis=1)
        fcent = 0.5 * (coords[lv[:, 0]] + coords[lv[:, 1]])
    else:
        e1 = coords[lv[:, 1]] - coords[lv[:, 0]]
        e2 = coords[lv[:, 2]] - coords[lv[:, 0]]
        normal = 0.5 * np.cross(e1, e2)
        area = np.linalg.norm(normal, axis=1)
        fcent = coords[lv].mean(axis=1)
    n_unit = normal / np.maximum(area, 1e-300)[:, None]
    # orient outward from cL
    flip = np.einsum("fd,fd->f", n_unit, fcent - ccent[cL]) < 0
    n_unit[flip] = -n_unit[flip]
    return {"cL": cL, "cR": cR, "normal": n_unit, "area": area,
            "fcent": fcent, "ccent": ccent, "vol": vol}


def _i32(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64).astype(np.int32), device=dev)


class FVPlex:
    """Cell-centered FVM for a scalar conservation law u_t + div F(u) = 0
    on a tri/quad/tet plex mesh.

    flux(u) -> tuple of dim flux components (elementwise torch ops);
    wavespeed(uL, uR, n) -> |df/du . n| bound for Rusanov, or the
    signed advection speed for upwind (n the (nf, dim) face normals).
    Boundary conditions: "outflow" (ghost copies the interior state) or
    ("dirichlet", g) with g a constant or a callable of the face
    centroids (numpy)."""

    def __init__(self, plex, flux, wavespeed, riemann="rusanov",
                 bc="outflow", order=1, limiter="barth"):
        self.plex = plex
        self.flux = flux
        self.wavespeed = wavespeed
        self.riemann = riemann
        self.bc = bc
        self.order = int(order)
        self.limiter_name = limiter
        g = face_geometry(plex)
        self.geom = g
        interior = g["cR"] >= 0
        self._interior = interior
        self._dev = {}
        if self.order >= 2:
            self._build_ls_tables()

    def _build_ls_tables(self):
        """Per-cell least-squares gradient pseudo-inverse over the
        face-neighbor stencil, padded to the max neighbor count
        (PetscFVLeastSquares, fv.c ComputeGradient). A cell's neighbours
        are in the order of the faces that join them (the reference's
        loop over the faces)."""
        g = self.geom
        nc = len(g["vol"])
        fint = np.flatnonzero(g["cR"] >= 0)
        L, R = g["cL"][fint], g["cR"][fint]
        cell_e = np.concatenate([L, R])
        nbr_e = np.concatenate([R, L])
        face_e = np.concatenate([fint, fint])
        order = np.lexsort((face_e, cell_e))
        cell_e, nbr_e = cell_e[order], nbr_e[order]
        cnt = np.bincount(cell_e, minlength=nc)
        kmax = int(cnt.max()) if nc else 0
        start = np.concatenate([[0], np.cumsum(cnt)])
        pos = np.arange(len(cell_e)) - start[cell_e]
        nb = np.zeros((nc, kmax), dtype=np.int64)
        mask = np.zeros((nc, kmax))
        nb[cell_e, pos] = nbr_e
        mask[cell_e, pos] = 1.0
        dx = (g["ccent"][nb] - g["ccent"][:, None, :]) * mask[..., None]
        # pinv of the (kmax, dim) displacement matrix per cell (batched)
        pinv = np.linalg.pinv(dx)                   # (nc, dim, kmax)
        self._ls = {"nb": nb, "mask": mask, "pinv": pinv}

    def _tables(self):
        """The face tables on the device, built once per device."""
        dev, dt = config.device(), config.real_dtype()
        key = (str(dev), dt)
        tab = self._dev.get(key)
        if tab is not None:
            return tab
        g = self.geom
        nc, nf = len(g["vol"]), len(g["cL"])
        dim = g["ccent"].shape[1]
        cL, cR = g["cL"], g["cR"]
        cRr = np.maximum(cR, 0)
        fint = np.flatnonzero(self._interior)

        def T(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)

        tab = {
            "cL": _i32(cL, dev), "cRr": _i32(cRr, dev),
            "interior": torch.as_tensor(self._interior, device=dev),
            "n": T(g["normal"]), "area": T(g["area"]), "vol": T(g["vol"]),
            # X1 signed: -fa into the left cells, then +fa into the interior
            # right cells
            "flux_scatter": scatter_table(
                np.concatenate([cL, cR[fint]]), np.concatenate([np.arange(nf), fint]), nc, nf,
                w=np.concatenate([-np.ones(nf), np.ones(len(fint))]), device=dev, dtype=dt),
        }
        ls = getattr(self, "_ls", None)
        if self.order >= 2 and ls is not None:
            kmax = ls["nb"].shape[1]
            tab.update({
                "nb": _i32(ls["nb"].reshape(-1), dev), "kmax": kmax,
                "mask": T(ls["mask"]), "pinv": T(ls["pinv"]),
                "gradL": _i32((cL[:, None] * dim + np.arange(dim)).reshape(-1), dev),
                "gradR": _i32((cRr[:, None] * dim + np.arange(dim)).reshape(-1), dev),
                "dxf_L": T(g["fcent"] - g["ccent"][cL]),
                "dxf_R": T(g["fcent"] - g["ccent"][cRr]),
                # X1 min: aL over the left cells, then aR over the interior
                # right cells, from the source cat(aL, aR)
                "lim_scatter": scatter_table(
                    np.concatenate([cL, cR[fint]]), np.concatenate([np.arange(nf), nf + fint]),
                    nc, 2 * nf, device=dev, dtype=dt),
            })
        bc = self.bc
        if isinstance(bc, tuple) and bc[0] == "dirichlet":
            gval = bc[1]
            tab["gb"] = T(gval(np.asarray(g["fcent"])) if callable(gval)
                          else np.full(nf, float(gval)))
        self._dev[key] = tab
        return tab

    def makeRHS(self):
        g = self.geom
        dim = g["ccent"].shape[1]
        nc = len(g["vol"])
        flux, wavespeed = self.flux, self.wavespeed
        order, limname = self.order, self.limiter_name
        has_ls = getattr(self, "_ls", None) is not None
        riemann = self.riemann

        def rhs(t, u):
            tab = self._tables()
            cL, cRr, interior = tab["cL"], tab["cRr"], tab["interior"]
            n, gb = tab["n"], tab.get("gb")
            npad = u.shape[0]
            u = u[:nc].contiguous()

            def fn_dot(v):
                F = flux(v)
                s = F[0] * n[:, 0]
                for d in range(1, dim):
                    s = s + F[d] * n[:, d]
                return s

            uL0 = gather(u, cL, check=False)
            uRi = gather(u, cRr, check=False)
            uR0 = torch.where(interior, uRi, uL0 if gb is None else gb)
            if order >= 2 and has_ls:
                mask = tab["mask"]
                un = gather(u, tab["nb"], check=False).reshape(nc, tab["kmax"])
                du = (un - u[:, None]) * mask
                # the per-cell (dim x kmax) products as one elementwise pass
                # (an einsum here becomes a batched GEMV of a million tiny
                # problems on the card)
                grad = (tab["pinv"] * du[:, None, :]).sum(dim=2).contiguous()
                # Barth-Jespersen: cell slope scaled so every face value
                # stays within the neighbor min/max envelope
                env = torch.where(mask > 0, un, u[:, None])
                umin = torch.minimum(u, torch.min(env, dim=1).values).contiguous()
                umax = torch.maximum(u, torch.max(env, dim=1).values).contiguous()
                gflat = grad.reshape(-1)
                dL = (gather(gflat, tab["gradL"], check=False).reshape(-1, dim)
                      * tab["dxf_L"]).sum(dim=1)
                dR = (gather(gflat, tab["gradR"], check=False).reshape(-1, dim)
                      * tab["dxf_R"]).sum(dim=1)
                if limname in ("barth", "minmod", "none"):
                    def alpha(d_, ui, lo, hi):
                        pos = torch.where(d_ > 1e-300,
                                          (hi - ui) / torch.where(
                                              d_ > 1e-300, d_, 1.0), 1.0)
                        neg = torch.where(d_ < -1e-300,
                                          (lo - ui) / torch.where(
                                              d_ < -1e-300, d_, 1.0), 1.0)
                        a = torch.where(d_ > 1e-300, pos,
                                        torch.where(d_ < -1e-300, neg, 1.0))
                        return torch.clip(a, 0.0, 1.0)
                    # per-cell limiter = min over the cell's faces: X1's
                    # min mode over both sides' face values
                    aL = alpha(dL, uL0, gather(umin, cL, check=False),
                               gather(umax, cL, check=False))
                    aR = alpha(dR, uRi, gather(umin, cRr, check=False),
                               gather(umax, cRr, check=False))
                    lim = torch.ones((nc,), dtype=u.dtype, device=u.device)
                    if limname != "none":
                        lim = dst_scatter(tab["lim_scatter"], torch.cat([aL, aR]),
                                          out=lim, mode="min")
                    uL = uL0 + gather(lim, cL, check=False) * dL
                    uR = torch.where(interior, uRi + gather(lim, cRr, check=False) * dR,
                                     uR0)
                else:
                    uL, uR = uL0 + dL, torch.where(interior, uRi + dR, uR0)
            else:
                uL, uR = uL0, uR0
            if riemann == "upwind":
                s = wavespeed(uL, uR, n)
                fh = torch.where(s >= 0, fn_dot(uL), fn_dot(uR))
            else:  # rusanov (local Lax-Friedrichs)
                smax = torch.abs(wavespeed(uL, uR, n))
                fh = 0.5 * (fn_dot(uL) + fn_dot(uR)) \
                    - 0.5 * smax * (uR - uL)
            fa = (fh * tab["area"]).contiguous()
            out = dst_scatter(tab["flux_scatter"], fa) / tab["vol"]
            if npad > nc:
                out = torch.nn.functional.pad(out, (0, npad - nc))
            return out

        return rhs
