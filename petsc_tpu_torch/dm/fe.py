"""DT / PetscFE / PetscDS — quadrature, tabulated finite elements, and
pointwise-weak-form assembly.

Behavioral reference: src/dm/dt (PetscDTGaussJacobiQuadrature dt.c,
PetscQuadrature), PetscSpace/PetscDualSpace/PetscFE (tabulated basis +
derivatives at quadrature points), and PetscDS's pointwise residual
kernels f0(u, ∇u, x) (test-function term) and f1(u, ∇u, x) (test-gradient
term) with the Jacobian blocks g0..g3 (plexfem.c assembly loops).

Counterpart of ``petsc_tpu/dm/fe.py``. Tabulation, the dof layout and the
special element families are host numpy, as in the reference (the dof
layout's and the edge numbering's loops over cells are vectorised with
the reference's numbering: each entity numbered at its first occurrence
over the cells). The DS assembly runs on the device :func:`init` chose:
the element solution is one K8 gather ``u[conn]`` (ops/gather_kernels.py),
the element kernel is batched over the cells (the basis push-forward and
the quadrature contractions are ``torch.einsum``; the user's pointwise
f0/f1 run over every quadrature point of every cell under
``torch.func.vmap``), and the scatter-add into the global residual is
X1's add mode (ops/pc_kernels.py ``dst_scatter``) on a table built once
per DS and device, whose entry order is the reference's, so the plain
version on the CPU gives the reference's sums. The per-cell geometry (J,
det J, J^-1 and the quadrature points) is computed once per device, with
the closed forms _det_small/_inv_small. Element Jacobians are the
forward-mode derivative (``torch.func.jvp``, one tangent per element dof,
batched by ``torch.func.vmap``) of the same kernel, so any residual form
gets an exact consistent tangent. User pointwise functions are torch and
out of place (``torch.where``, no writes into an argument): an in-place
write under ``torch.func`` drops the tangent.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.gather_kernels import gather
from ..ops.pc_kernels import dst_scatter, scatter_table


# ---------------------------------------------------------------------
# quadrature (PetscDTGaussJacobiQuadrature role)
# ---------------------------------------------------------------------

def gauss_quadrature(dim, npoints_1d, cell="simplex"):
    """Quadrature (points, weights) on the reference cell.
    simplex dim 2: degree-exact Dunavant rules (1, 3, 6 pts);
    tensor cells: Gauss-Legendre products."""
    if cell == "tensor" or dim == 1:
        x, w = np.polynomial.legendre.leggauss(npoints_1d)
        x = 0.5 * (x + 1.0)         # [0,1]
        w = 0.5 * w
        if dim == 1:
            return x[:, None], w
        pts = np.array(np.meshgrid(*([x] * dim), indexing="ij"))
        pts = pts.reshape(dim, -1).T
        ww = w
        for _ in range(dim - 1):
            ww = np.outer(ww, w).reshape(-1)
        return pts, ww
    if dim == 2:
        if npoints_1d <= 1:          # degree 1
            return np.array([[1 / 3, 1 / 3]]), np.array([0.5])
        if npoints_1d == 2:          # degree 2 (3-point)
            return (np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6],
                              [1 / 6, 2 / 3]]),
                    np.array([1 / 6, 1 / 6, 1 / 6]))
        # degree 4 (6-point Dunavant)
        a, b = 0.445948490915965, 0.091576213509771
        pts = np.array([[a, a], [1 - 2 * a, a], [a, 1 - 2 * a],
                        [b, b], [1 - 2 * b, b], [b, 1 - 2 * b]])
        wa, wb = 0.111690794839005, 0.054975871827661
        return pts, np.array([wa, wa, wa, wb, wb, wb])
    raise NotImplementedError(f"quadrature dim={dim} cell={cell}")


def stroud_conical_quadrature(dim, degree):
    """Simplex quadrature exact to `degree` by the Stroud conical product
    (PetscDTStroudConicalQuadrature, dt.c): 1-D Gauss-Jacobi rules with
    weights (1-x)^a collapsed through the Duffy map. Works for any dim
    and degree (unlike the tabulated Dunavant special cases)."""
    from scipy.special import roots_jacobi
    n = degree // 2 + 1

    def rule(alpha):
        x, w = roots_jacobi(n, alpha, 0.0)
        # map [-1,1] with weight (1-x)^alpha to [0,1] with (1-t)^alpha
        t = 0.5 * (x + 1.0)
        wt = w * 0.5 ** (alpha + 1)
        return t, wt

    axes = [rule(dim - 1 - i) for i in range(dim)]
    pts = np.zeros((n ** dim, dim))
    wts = np.ones(n ** dim)
    idx = np.stack(np.meshgrid(*[np.arange(n)] * dim,
                               indexing="ij"), axis=-1).reshape(-1, dim)
    for k, ii in enumerate(idx):
        rem = 1.0
        for d in range(dim):
            t, wt = axes[d]
            pts[k, d] = rem * t[ii[d]]
            rem *= (1.0 - t[ii[d]])
            wts[k] *= wt[ii[d]]
    return pts, wts


# ---------------------------------------------------------------------
# PetscSpace / PetscDualSpace / tabulation (Lagrange family)
# ---------------------------------------------------------------------

def _p_monomials(dim, k):
    """Exponent multi-indices of P_k (total degree <= k)."""
    out = []

    def rec(prefix, left, d):
        if d == dim:
            out.append(tuple(prefix))
            return
        for e in range(left + 1):
            rec(prefix + [e], left - e, d + 1)

    rec([], k, 0)
    return np.asarray(sorted(out), dtype=np.int64)


def _q_monomials(dim, k):
    """Exponent multi-indices of Q_k (max degree <= k per axis)."""
    grids = np.meshgrid(*[np.arange(k + 1)] * dim, indexing="ij")
    return np.stack(grids, axis=-1).reshape(-1, dim)


def _eval_monomials(expo, pts):
    """(npts, nb) monomial values and (npts, nb, dim) gradients."""
    npts, dim = pts.shape
    nb = len(expo)
    V = np.ones((npts, nb))
    G = np.zeros((npts, nb, dim))
    for j, e in enumerate(expo):
        for d in range(dim):
            V[:, j] *= pts[:, d] ** e[d]
        for d in range(dim):
            g = (e[d] * pts[:, d] ** max(e[d] - 1, 0)
                 if e[d] > 0 else np.zeros(npts))
            for dd in range(dim):
                if dd != d:
                    g = g * pts[:, dd] ** e[dd]
            G[:, j, d] = g
    return V, G


def _lagrange_nodes(dim, k, cell):
    """PetscDualSpace Lagrange: nodal points on the reference cell, with
    each node classified by the sub-entity it lives on:
    ('vertex', v) | ('edge', (a, b), pos) | ('face', (a, b, c)) |
    ('interior',). Simplex nodes are the barycentric lattice i/k."""
    if cell == "tensor":
        ax = np.linspace(0.0, 1.0, k + 1)
        grids = np.meshgrid(*[ax] * dim, indexing="ij")
        pts = np.stack(grids, axis=-1).reshape(-1, dim)
        kinds = []
        for p in pts:
            on0 = [abs(c) < 1e-12 for c in p]
            on1 = [abs(c - 1) < 1e-12 for c in p]
            onb = [a or b for a, b in zip(on0, on1)]
            if all(onb):
                kinds.append(("vertex", _tensor_corner(p, dim)))
            elif dim == 3 and any(onb):
                nfree = sum(not b for b in onb)
                if nfree == 1:
                    # hex edge node: endpoints at free-axis 0 / 1
                    d = onb.index(False)
                    lo, hi = list(p), list(p)
                    lo[d], hi[d] = 0.0, 1.0
                    a = _tensor_corner(np.array(lo), 3)
                    b = _tensor_corner(np.array(hi), 3)
                    kinds.append(("edge", (a, b), int(round(p[d] * k))))
                elif nfree == 2:
                    # hex face node: corners listed (u,v) = 00,01,10,11
                    # along the two free axes + the node's lattice
                    # position (a, b) on them — build_dof_layout numbers
                    # the (k-1)^2 face-interior dofs in the face's
                    # canonical (lowest-global-corner) frame so
                    # neighboring hexes agree (Q3+; Q2's single centroid
                    # degenerates to rank 0)
                    d = [i for i, b in enumerate(onb) if b][0]
                    free = [i for i in range(3) if i != d]
                    corners = []
                    for u in (0.0, 1.0):
                        for v in (0.0, 1.0):
                            q = list(p)
                            q[free[0]], q[free[1]] = u, v
                            corners.append(_tensor_corner(np.array(q), 3))
                    kinds.append(("face", tuple(corners),
                                  (int(round(p[free[0]] * k)),
                                   int(round(p[free[1]] * k)))))
                else:
                    kinds.append(("interior",))
            elif dim == 2 and any(onb):
                # quad edge nodes: corners ccw 0=00,1=10,2=11,3=01; the
                # local (a, b) pair fixes the direction pos counts along
                x, y = p
                if on0[1]:
                    kinds.append(("edge", (0, 1), int(round(x * k))))
                elif on1[0]:
                    kinds.append(("edge", (1, 2), int(round(y * k))))
                elif on1[1]:
                    kinds.append(("edge", (3, 2), int(round(x * k))))
                else:
                    kinds.append(("edge", (0, 3), int(round(y * k))))
            else:
                kinds.append(("interior",))
        return pts, kinds
    if cell == "prism":
        if k > 2:
            raise NotImplementedError(
                "prism Lagrange: order 1-2 only (k>=3 has multiple "
                "quad-face nodes needing oriented face numbering)")
        # corners: 0,1,2 bottom triangle (z=0), 3,4,5 top (z=1)
        tri = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)]
        tpts, tkinds = [], []
        # triangle lattice of order k with entity classification
        for i in range(k + 1):
            for j in range(k + 1 - i):
                x, y = i / max(k, 1), j / max(k, 1)
                lam = (1 - x - y, x, y)
                nz = [v for v, l in enumerate(lam) if l > 1e-12]
                tpts.append((x, y))
                if len(nz) == 1:
                    tkinds.append(("tv", nz[0]))
                else:
                    tkinds.append(("te", tuple(nz)))
        pts, kinds = [], []
        for (x, y), tk in zip(tpts, tkinds):
            for iz in range(k + 1):
                z = iz / max(k, 1)
                pts.append((x, y, z))
                zend = abs(z) < 1e-12 or abs(z - 1) < 1e-12
                top = 3 if z > 0.5 else 0
                if tk[0] == "tv" and zend:
                    kinds.append(("vertex", tk[1] + top))
                elif tk[0] == "tv":
                    # vertical edge v -- v+3
                    kinds.append(("edge", (tk[1], tk[1] + 3),
                                  int(round(z * k))))
                elif zend:
                    # horizontal triangle edge at z in {0, 1}
                    a, b = tk[1]
                    # position along a->b: barycentric coordinate of b
                    lamb = (1 - x - y, x, y)[b]
                    kinds.append(("edge", (a + top, b + top),
                                  int(round(lamb * k))))
                else:
                    # quad face spanned by the tri edge x the z axis
                    a, b = tk[1]
                    kinds.append(("face", (a, b, a + 3, b + 3)))
        return np.asarray(pts, dtype=np.float64), kinds
    # simplex barycentric lattice: multi-indices (b0..bd) summing to k;
    # slot i <-> vertex i (vertex 0 at the origin), coords = (b1..bd)/k
    out = []

    def rec(prefix, left, d):
        if d == dim:
            out.append(prefix + [left])
            return
        for e in range(left + 1):
            rec(prefix + [e], left - e, d + 1)

    rec([], k, 0)
    bary = np.asarray(out, dtype=np.int64)       # (nb, dim+1)
    pts = bary[:, 1:] / max(k, 1)                # coords = (b1..bd)/k
    kinds = []
    for bb in bary:
        nz = np.nonzero(bb)[0]
        if len(nz) == 1:
            kinds.append(("vertex", int(nz[0])))
        elif len(nz) == 2:
            a, b = int(nz[0]), int(nz[1])
            # position along the edge a->b (1..k-1)
            kinds.append(("edge", (a, b), int(bb[b])))
        elif len(nz) == 3 and dim == 3:
            # P4+: several interior nodes per face — carry the node's
            # barycentric sub-multiindex on the face's three vertices so
            # build_dof_layout can number them in the face's CANONICAL
            # (sorted-global-vertex) frame; neighbors then agree
            # (the oriented face-dof numbering plexfem.c gets from
            # PetscSection closure permutations)
            tri = tuple(int(v) for v in nz)
            kinds.append(("face", tri,
                          tuple(int(bb[v]) for v in tri)))
        else:
            kinds.append(("interior",))
    return pts, kinds


def _face_interior_index(k):
    """Lexicographic rank of each interior barycentric triple (i, j, l),
    i+j+l = k, all >= 1, of a face of order k; returns (dict, count)."""
    idx = {}
    for i in range(1, k - 1):
        for j in range(1, k - i):
            l = k - i - j
            if l >= 1:
                idx[(i, j, l)] = len(idx)
    return idx, len(idx)


def _tensor_corner(p, dim):
    """Map a tensor-cell corner coordinate to the plex corner number
    (2-D quads: 00,10,11,01 counter-clockwise; 3-D hexes: the
    createBoxMesh ordering)."""
    bits = tuple(int(abs(c - 1) < 1e-12) for c in p)
    if dim == 2:
        return {(0, 0): 0, (1, 0): 1, (1, 1): 2, (0, 1): 3}[bits]
    order = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
             (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    return order.index(bits)


def prism_quadrature(deg):
    """Quadrature on the reference wedge (triangle x [0, 1]): Stroud
    conical in (x, y) tensored with Gauss in z, exact to `deg` in each
    factor (the DM_POLYTOPE_TRI_PRISM quadrature role)."""
    qp2, qw2 = stroud_conical_quadrature(2, deg)
    tz, wz = np.polynomial.legendre.leggauss(deg // 2 + 1)
    tz = 0.5 * (tz + 1.0)
    wz = 0.5 * wz
    qp = np.concatenate(
        [np.repeat(qp2, len(tz), axis=0),
         np.tile(tz, len(qp2))[:, None]], axis=1)
    qw = (qw2[:, None] * wz[None, :]).reshape(-1)
    return qp, qw


def _prism_monomials(k):
    """Exponents of P_k(x, y) x P_k(z) — the wedge polynomial space."""
    out = []
    for a in range(k + 1):
        for b in range(k + 1 - a):
            for c in range(k + 1):
                out.append((a, b, c))
    return np.asarray(sorted(out), dtype=np.int64)


def lagrange_fe(dim, k, cell="simplex", qdeg=None, ncomp=1):
    """PetscFECreateLagrange role: nodal Lagrange element of order k on a
    simplex, tensor, or prism (wedge) reference cell, any dim —
    PetscSpace (monomials) x PetscDualSpace (lattice nodes) inverted
    through the generalized Vandermonde, tabulated at a quadrature exact
    for degree 2k."""
    qdeg = qdeg if qdeg is not None else 2 * k
    if cell == "tensor":
        qp, qw = gauss_quadrature(dim, qdeg // 2 + 1, cell="tensor")
        expo = _q_monomials(dim, k)
    elif cell == "prism":
        if dim != 3:
            raise NotImplementedError("prism cells are 3-D")
        qp, qw = prism_quadrature(qdeg)
        expo = _prism_monomials(k)
    else:
        qp, qw = stroud_conical_quadrature(dim, qdeg)
        expo = _p_monomials(dim, k)
    nodes, kinds = _lagrange_nodes(dim, k, cell)
    Vn, _ = _eval_monomials(expo, nodes)
    C = np.linalg.inv(Vn)                         # coeffs: nodal basis
    Vq, Gq = _eval_monomials(expo, qp)
    B = Vq @ C                                    # (nq, nb)
    D = np.einsum("qmd,mb->qbd", Gq, C)           # (nq, nb, dim)
    fe = FE(f"{'q' if cell == 'tensor' else 'p'}{k}", dim, len(nodes),
            (qp, qw), B, D, "lagrange")
    fe.order = k
    fe.cell = cell
    fe.nodes = nodes
    fe.node_kinds = kinds
    fe.ncomp = ncomp
    return fe


# ---------------------------------------------------------------------
# tabulated spaces (PetscSpace/PetscFE role)
# ---------------------------------------------------------------------

class FE:
    """A tabulated scalar finite element on the reference cell: basis
    values B (nq, nb) and reference gradients D (nq, nb, dim) at the
    quadrature points (PetscFEGetCellTabulation)."""

    def __init__(self, name, dim, nb, quad, B, D, dof_kind):
        self.name = name
        self.dim = dim
        self.nb = nb
        self.qp, self.qw = quad
        self.B = B
        self.D = D
        self.dof_kind = dof_kind    # "vertex" | "vertex+edge" | "facet" | "lagrange"

    @classmethod
    def create(cls, kind, qdeg=2):
        """kind: 'p1' (linear tri), 'p2' (quadratic tri), 'q1' (bilinear
        quad)."""
        if kind == "p1":
            qp, qw = gauss_quadrature(2, qdeg)
            x, y = qp[:, 0], qp[:, 1]
            B = np.stack([1 - x - y, x, y], axis=1)
            D = np.broadcast_to(
                np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]),
                (len(qp), 3, 2)).copy()
            return cls("p1", 2, 3, (qp, qw), B, D, "vertex")
        if kind == "p2":
            qp, qw = gauss_quadrature(2, 3)
            x, y = qp[:, 0], qp[:, 1]
            l0, l1, l2 = 1 - x - y, x, y
            B = np.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1),
                          l2 * (2 * l2 - 1), 4 * l0 * l1, 4 * l1 * l2,
                          4 * l0 * l2], axis=1)
            dl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
            D = np.zeros((len(qp), 6, 2))
            for q in range(len(qp)):
                lam = np.array([l0[q], l1[q], l2[q]])
                for d in range(2):
                    D[q, 0, d] = (4 * lam[0] - 1) * dl[0, d]
                    D[q, 1, d] = (4 * lam[1] - 1) * dl[1, d]
                    D[q, 2, d] = (4 * lam[2] - 1) * dl[2, d]
                    D[q, 3, d] = 4 * (lam[1] * dl[0, d] + lam[0] * dl[1, d])
                    D[q, 4, d] = 4 * (lam[2] * dl[1, d] + lam[1] * dl[2, d])
                    D[q, 5, d] = 4 * (lam[2] * dl[0, d] + lam[0] * dl[2, d])
            return cls("p2", 2, 6, (qp, qw), B, D, "vertex+edge")
        if kind == "q1":
            qp, qw = gauss_quadrature(2, qdeg, cell="tensor")
            x, y = qp[:, 0], qp[:, 1]
            B = np.stack([(1 - x) * (1 - y), x * (1 - y),
                          (1 - x) * y, x * y], axis=1)
            D = np.stack([
                np.stack([-(1 - y), -(1 - x)], axis=1),
                np.stack([(1 - y), -x], axis=1),
                np.stack([-y, (1 - x)], axis=1),
                np.stack([y, x], axis=1)], axis=1)
            return cls("q1", 2, 4, (qp, qw), B, D, "vertex")
        raise KeyError(kind)


# build_edges pair order (01, 12, 02) -> opposite vertices — the single
# source of the CR edge convention (crouzeix_raviart_fe, cr_cell_gradients)
_CR_OPP = (2, 0, 1)


def crouzeix_raviart_fe():
    """Nonconforming P1 (Crouzeix-Raviart) on triangles: dofs at edge
    MIDPOINTS, basis phi_k = 1 - 2 lambda_opp(k) — continuous only at
    the midpoints (the PetscDualSpace Lagrange 'facet'/continuity-none
    member; the classic inf-sup-stable velocity space for Stokes)."""
    qp, qw = stroud_conical_quadrature(2, 2)
    x, y = qp[:, 0], qp[:, 1]
    lam = np.stack([1 - x - y, x, y], axis=1)       # (nq, 3)
    gl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    opp = _CR_OPP            # edge (0,1)->vert 2, (1,2)->0, (0,2)->1
    B = np.stack([1 - 2 * lam[:, opp[k]] for k in range(3)], axis=1)
    D = np.broadcast_to(
        np.stack([-2 * gl[opp[k]] for k in range(3)]),
        (len(qp), 3, 2)).copy()
    fe = FE("cr", 2, 3, (qp, qw), B, D, "facet")
    fe.cell = "simplex"
    fe.ncomp = 1
    return fe


def p0disc_fe(dim, qdeg=2):
    """Piecewise-constant discontinuous element (P0disc — the pressure
    space of the CR/P0 Stokes pair; PetscFECreateDefault with k=0 and
    continuity none): one dof per cell."""
    qp, qw = stroud_conical_quadrature(dim, qdeg)
    B = np.ones((len(qp), 1))
    D = np.zeros((len(qp), 1, dim))
    fe = FE("p0disc", dim, 1, (qp, qw), B, D, "cell")
    fe.cell = "simplex"
    fe.ncomp = 1
    return fe


def number_by_first(keys):
    """Number the distinct rows of `keys` (m, k) in the order of their first
    occurrence, as a dict filled in row order numbers them: returns (ids
    (m,), the distinct rows in id order)."""
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.int64))
    if len(keys) == 0:
        return np.zeros(0, dtype=np.int64), keys
    order = np.lexsort(keys.T[::-1])            # stable: ties keep row order
    sk = keys[order]
    new = np.ones(len(sk), dtype=bool)
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    grp = np.empty(len(keys), dtype=np.int64)
    grp[order] = np.cumsum(new) - 1
    first = order[new]                           # each group's first row
    by_first = np.argsort(first, kind="stable")
    rank = np.empty(len(first), dtype=np.int64)
    rank[by_first] = np.arange(len(first))
    return rank[grp], keys[first[by_first]]


def build_edges(cells):
    """Edge numbering for P2 dofs: returns (edges (ne,2) sorted vertex
    pairs, cell2edge (ncell, 3) in local order (01, 12, 02))."""
    cells = np.asarray(cells, dtype=np.int64)
    pairs = np.stack([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [0, 2]]], axis=1)
    ids, edges = number_by_first(np.sort(pairs, axis=2).reshape(-1, 2))
    return edges, ids.reshape(len(cells), 3)


def _entity_ids(cells, kinds):
    """Number the edge/face sub-entities a Lagrange element's nodes live
    on (the PetscSection-over-strata role): returns (edge_locals, eids
    (nc, len(edge_locals)), edge count, face_locals, fids (nc,
    len(face_locals)), face key rows in id order). Edges are keyed by
    their sorted global pair, faces by their sorted global vertices, and
    numbered at their first occurrence over (cell, local entity)."""
    edge_locals = sorted({kk[1] for kk in kinds if kk[0] == "edge"})
    face_locals = sorted({kk[1] for kk in kinds if kk[0] == "face"})
    nc = len(cells)
    eids = np.zeros((nc, 0), dtype=np.int64)
    ne = 0
    if edge_locals:
        ek = np.stack([np.sort(cells[:, list(p)], axis=1) for p in edge_locals], axis=1)
        ids, uniq = number_by_first(ek.reshape(-1, 2))
        eids, ne = ids.reshape(nc, -1), len(uniq)
    fids = np.zeros((nc, 0), dtype=np.int64)
    fkeys = np.zeros((0, 0), dtype=np.int64)
    if face_locals:
        fk = np.stack([np.sort(cells[:, list(f)], axis=1) for f in face_locals], axis=1)
        ids, fkeys = number_by_first(fk.reshape(nc * len(face_locals), -1))
        fids = ids.reshape(nc, -1)
    return edge_locals, eids, ne, face_locals, fids, fkeys


def build_dof_layout(cells, coords, fe):
    """Global continuous dof numbering for a Lagrange FE: vertex dofs
    first, then (k-1) per edge (positions oriented from the LOWER global
    vertex so neighbors agree), then one per face (3-D P3 centroid),
    then per-cell interior dofs. Returns (conn (nc, nb), ndof,
    dof_coords (ndof, dim)) — the PetscDualSpace/PetscSection closure
    numbering of plexfem.c, vectorized per local node over all cells."""
    cells = np.asarray(cells, dtype=np.int64)
    nc = len(cells)
    nv = int(cells.max()) + 1 if nc else 0
    k = fe.order
    kinds = fe.node_kinds
    edge_locals, eids, ne, face_locals, fids, fkeys = _entity_ids(cells, kinds)
    nf = len(fkeys)
    per_edge = k - 1
    n_int = sum(1 for kk in kinds if kk[0] == "interior")
    # simplex faces carry (k-1)(k-2)/2 interior dofs for P4+ (the
    # bary-multiindex face kinds), hex quad faces (k-1)^2 (the lattice
    # kinds); single-dof face kinds (P3 centroid, prism quad) keep
    # per_face = 1
    face_kinds = [kk for kk in kinds if kk[0] == "face" and len(kk) > 2]
    fidx, per_face = None, 1
    quad_face = False
    if face_kinds:
        if len(face_kinds[0][1]) == 3:
            fidx, per_face = _face_interior_index(k)
        else:
            quad_face, per_face = True, (k - 1) ** 2
    fmap = None
    if face_kinds:
        fmap = {tuple(int(v) for v in row): i for i, row in enumerate(fkeys)}
    base_e = nv
    base_f = base_e + ne * per_edge
    base_i = base_f + nf * per_face
    ndof = base_i + nc * n_int
    conn = np.zeros((nc, fe.nb), dtype=np.int64)
    int_count = 0
    for j, kk in enumerate(kinds):
        if kk[0] == "vertex":
            conn[:, j] = cells[:, kk[1]]
        elif kk[0] == "edge":
            (a, b), pos = kk[1], kk[2]
            ga, gb = cells[:, a], cells[:, b]
            eid = eids[:, edge_locals.index(kk[1])]
            p = np.where(ga <= gb, pos, k - pos)       # orient low -> high
            conn[:, j] = base_e + eid * per_edge + (p - 1)
        elif kk[0] == "face":
            tri = kk[1]
            if len(kk) > 2 and not quad_face:
                # canonical face frame: permute the node's barycentric
                # weights into ascending-global-vertex order; both cells
                # sharing the face compute the same (fid, rank)
                bary = kk[2]
                for c in range(nc):
                    g = [int(cells[c, v]) for v in tri]
                    order = np.argsort(g)
                    key = tuple(g[o] for o in order)
                    m = tuple(bary[o] for o in order)
                    conn[c, j] = base_f + fmap[key] * per_face + fidx[m]
            elif len(kk) > 2:
                # quad face (hex): corners listed (u,v)=00,01,10,11 with
                # node lattice position (a, b). Canonical frame: origin
                # at the lowest-GLOBAL corner, first axis toward the
                # smaller-global of its two face neighbors — the same
                # intrinsic numbering from both sides of the face.
                ia, ib = kk[2]
                for c in range(nc):
                    g = [int(cells[c, v]) for v in tri]
                    mloc = int(np.argmin(g))
                    u0, v0 = divmod(mloc, 2)
                    nA = 2 * (1 - u0) + v0      # u-direction neighbor
                    nB = 2 * u0 + (1 - v0)      # v-direction neighbor
                    sa = ia if u0 == 0 else k - ia
                    sb = ib if v0 == 0 else k - ib
                    i1, i2 = (sa, sb) if g[nA] <= g[nB] else (sb, sa)
                    rank = (i1 - 1) * (k - 1) + (i2 - 1)
                    key = tuple(sorted(g))
                    conn[c, j] = base_f + fmap[key] * per_face + rank
            else:
                conn[:, j] = base_f + fids[:, face_locals.index(tri)]
        else:
            conn[:, j] = base_i + np.arange(nc) * n_int + int_count
            int_count += 1
    # physical node coordinates (affine simplex / multilinear tensor map)
    dof_coords = np.zeros((ndof, coords.shape[1]))
    phys = _map_nodes(coords, cells, fe)
    dof_coords[conn.reshape(-1)] = phys.reshape(-1, coords.shape[1])
    return conn, ndof, dof_coords


def _map_nodes(coords, cells, fe):
    """Reference nodes -> physical coords per cell, (nc, nb, dim)."""
    xe = coords[cells]
    if fe.cell == "simplex":
        lam0 = 1.0 - fe.nodes.sum(axis=1, keepdims=True)
        lam = np.concatenate([lam0, fe.nodes], axis=1)   # (nb, d+1)
        return np.einsum("bv,cvd->cbd", lam, xe[:, : fe.dim + 1])
    if fe.cell == "prism":
        Bg, _ = _geom_prism(fe.nodes)
        return np.einsum("bv,cvd->cbd", Bg, xe)
    # multilinear corner map
    Bg, _ = _geom_tabulation(fe.dim, fe.nodes)
    return np.einsum("bv,cvd->cbd", Bg, xe)


def _geom_prism(pts):
    """P1 wedge geometry basis values/gradients at `pts` (isoparametric
    map for prism cells): lambda_i(x, y) x {1-z, z}, corners 0-2 bottom,
    3-5 top."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    lam = np.stack([1 - x - y, x, y], axis=1)            # (nq, 3)
    gl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    B = np.concatenate([lam * (1 - z)[:, None], lam * z[:, None]], axis=1)
    D = np.zeros((len(pts), 6, 3))
    for i in range(3):
        D[:, i, :2] = gl[i] * (1 - z)[:, None]
        D[:, i, 2] = -lam[:, i]
        D[:, i + 3, :2] = gl[i] * z[:, None]
        D[:, i + 3, 2] = lam[:, i]
    return B, D


def _geom_p2_tri(pts):
    """P2 triangle geometry basis values/gradients at `pts` — the
    isoparametric quadratic coordinate map for curved cells
    (plexgeometry.c's high-order coordinate-field role).  Node order:
    vertices 0,1,2 then edge midpoints (01),(12),(02) — the build_edges
    local order."""
    x, y = pts[:, 0], pts[:, 1]
    l0, l1, l2 = 1 - x - y, x, y
    B = np.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1),
                  l2 * (2 * l2 - 1), 4 * l0 * l1, 4 * l1 * l2,
                  4 * l0 * l2], axis=1)
    dl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    D = np.zeros((len(pts), 6, 2))
    lam = np.stack([l0, l1, l2], axis=1)
    for d in range(2):
        D[:, 0, d] = (4 * lam[:, 0] - 1) * dl[0, d]
        D[:, 1, d] = (4 * lam[:, 1] - 1) * dl[1, d]
        D[:, 2, d] = (4 * lam[:, 2] - 1) * dl[2, d]
        D[:, 3, d] = 4 * (lam[:, 1] * dl[0, d] + lam[:, 0] * dl[1, d])
        D[:, 4, d] = 4 * (lam[:, 2] * dl[1, d] + lam[:, 1] * dl[2, d])
        D[:, 5, d] = 4 * (lam[:, 2] * dl[0, d] + lam[:, 0] * dl[2, d])
    return B, D


def _geom_tabulation(dim, pts):
    """Q1 corner geometry basis values/gradients at `pts` (isoparametric
    map for tensor cells), corners in the plex ordering."""
    x = pts[:, 0]
    if dim == 2:
        y = pts[:, 1]
        B = np.stack([(1 - x) * (1 - y), x * (1 - y),
                      x * y, (1 - x) * y], axis=1)
        D = np.stack([
            np.stack([-(1 - y), -(1 - x)], axis=1),
            np.stack([(1 - y), -x], axis=1),
            np.stack([y, x], axis=1),
            np.stack([-y, (1 - x)], axis=1)], axis=1)
        return B, D
    y, z = pts[:, 1], pts[:, 2]
    corners = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
               (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    B = np.stack([
        (x if cx else 1 - x) * (y if cy else 1 - y) * (z if cz else 1 - z)
        for cx, cy, cz in corners], axis=1)
    D = np.zeros((len(pts), 8, 3))
    for v, (cx, cy, cz) in enumerate(corners):
        fx, gx = (x, np.ones_like(x)) if cx else (1 - x, -np.ones_like(x))
        fy, gy = (y, np.ones_like(y)) if cy else (1 - y, -np.ones_like(y))
        fz, gz = (z, np.ones_like(z)) if cz else (1 - z, -np.ones_like(z))
        D[:, v, 0] = gx * fy * fz
        D[:, v, 1] = fx * gy * fz
        D[:, v, 2] = fx * fy * gz
    return B, D


# ---------------------------------------------------------------------
# H(div): lowest-order Raviart-Thomas (PetscDualSpace RT family)
# ---------------------------------------------------------------------

def rt0_mixed_poisson(plex, f=1.0):
    """Mixed Poisson (Darcy) with RT0 x P0 on a triangle mesh — the
    H(div) member of the PetscSpace/PetscDualSpace family
    (src/dm/dt/dualspace/impls/lagrange covers H1; this covers the
    PETSCDUALSPACEBDM/RT role at lowest order):

        (sigma, tau) + (u, div tau) = 0        for all tau in RT0
        (div sigma, v)             = -(f, v)   for all v in P0

    Reference-element basis with unit edge fluxes (psi_0 = (x, y-1),
    psi_1 = (x, y), psi_2 = (1-x, -y); |div psi| = 2), mapped by the
    contravariant Piola transform sigma = J psi / detJ so inter-element
    normal fluxes are continuous; the edge dof sign follows the global
    low->high edge orientation. The div block is EXACTLY the signed
    cell-edge incidence matrix (unit fluxes), so div sigma_h + f = 0
    holds elementwise to machine precision — the defining conservation
    property of the mixed method.

    Returns (K, rhs, nedges): K the (ne+nc) x (ne+nc) saddle system as a
    MatAIJ (fields: sigma = edge dofs first, u = cell dofs), rhs a Vec,
    nedges for splitting (feed to PCFieldSplit Schur)."""
    import scipy.sparse as sp
    from ..mat.aij import MatAIJ
    from ..vec.vec import Vec as _Vec
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    if cells.shape[1] != 3 or coords.shape[1] != 2:
        from ..sys.error import Error
        raise Error("rt0_mixed_poisson: 2-D triangle meshes only")
    edges, c2e = build_edges(cells)
    ne, nc = len(edges), len(cells)
    pairs = [(0, 1), (1, 2), (0, 2)]
    # per-cell geometry
    v = coords[cells]                                  # (nc, 3, 2)
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    # orientation: +1 when the local (a, b) direction matches the global
    # low->high convention stored in `edges` (the dof is the flux along
    # the RIGHT normal of the global edge direction — the contravariant
    # Piola map preserves directed-edge fluxes exactly)
    sgn = np.stack([np.where(cells[:, a] < cells[:, b], 1.0, -1.0)
                    for a, b in pairs], axis=1)        # (nc, 3)
    # reference basis with +1 flux along each local edge's directed
    # right-normal: psi_0=(x,y-1), psi_1=(x,y), psi_2=(1-x,-y)
    qp, qw = stroud_conical_quadrature(2, 2)
    x, y = qp[:, 0], qp[:, 1]
    psi = np.stack([np.stack([x, y - 1], axis=1),
                    np.stack([x, y], axis=1),
                    np.stack([1 - x, -y], axis=1)])    # (3, nq, 2)
    # M_ij per cell = sgn_i sgn_j / |detJ| * sum_q w_q psi_i^T (J^T J) psi_j
    JtJ = np.einsum("ced,cef->cdf", J, J)              # (nc, 2, 2)
    Mref = np.einsum("iqd,cdf,jqf,q->cij", psi, JtJ, psi, qw)
    Me = (sgn[:, :, None] * sgn[:, None, :]) * Mref \
        / np.abs(detJ)[:, None, None]
    rows = np.repeat(c2e, 3, axis=1).reshape(-1)
    cols = np.tile(c2e, (1, 3)).reshape(-1)
    M = sp.csr_matrix((Me.reshape(-1), (rows, cols)), shape=(ne, ne))
    # div block: outward flux = directed flux x (+1, +1, -1) x sign(detJ)
    # (local edge (0,2) is traversed backwards in the ccw boundary), so
    # B[cell, edge] = sgn * o * s_or: the signed incidence matrix (unit
    # fluxes -> exact elementwise conservation)
    o = np.array([1.0, 1.0, -1.0])
    s_or = np.sign(detJ)
    Bv = sgn * o[None, :] * s_or[:, None]
    B = sp.csr_matrix((Bv.reshape(-1),
                       (np.repeat(np.arange(nc), 3), c2e.reshape(-1))),
                      shape=(nc, ne))
    K = sp.bmat([[M, B.T], [B, None]], format="csr")
    rhs = np.zeros(ne + nc)
    fv = np.full(nc, float(f)) if np.isscalar(f) else np.asarray(f)
    rhs[ne:] = -fv * area
    return (MatAIJ.from_scipy(K, comm=plex.comm),
            _Vec.from_array(rhs, comm=plex.comm), ne)


def bdm1_mixed_poisson(plex, f=1.0):
    """Mixed Poisson with BDM1 x P0 on triangles — the higher-order
    H(div) member (PETSCDUALSPACEBDM, src/dm/dt/dualspace/impls: full P1
    vector fields, 2 normal-flux moments per edge), one order above RT0:
    the flux converges at O(h^2) in L2 where RT0 gives O(h).

        (sigma, tau) + (u, div tau) = 0        for all tau in BDM1
        (div sigma, v)             = -(f, v)   for all v in P0

    TPU-idiomatic construction: instead of a reference element + Piola
    map, each cell's 6 basis fields are built DIRECTLY on the physical
    cell by inverting the (vectorized, batched) 6x6 generalized
    Vandermonde of the moment dofs over centroid-centered monomial P1
    fields. The dofs are globally defined (edge lo->hi orientation,
    right normal, Legendre weights 1 and 2t-1), so the two cells sharing
    an edge agree on them — that IS normal continuity for a linear
    normal trace. The div block touches only the zeroth moments with
    outward signs (signed incidence), so elementwise conservation
    div sigma_h = -mean(f) holds to machine precision.

    Returns (K MatAIJ, rhs Vec, ns = 2*nedges, eval_sigma) with
    eval_sigma(s) -> (sig (nc, nq, 2), xq (nc, nq, 2), w (nc, nq))
    evaluating the flux field at the cell quadrature points (for error
    norms)."""
    import scipy.sparse as sp
    from ..mat.aij import MatAIJ
    from ..vec.vec import Vec as _Vec
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    if cells.shape[1] != 3 or coords.shape[1] != 2:
        from ..sys.error import Error
        raise Error("bdm1_mixed_poisson: 2-D triangle meshes only")
    edges, c2e = build_edges(cells)
    ne, nc = len(edges), len(cells)
    pairs = [(0, 1), (1, 2), (0, 2)]
    v = coords[cells]                                   # (nc, 3, 2)
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    cc = v.mean(axis=1)                                 # centroids
    h = np.sqrt(area)

    def monos(x, c):
        """Centered/scaled monomial P1 vector fields at points x
        (..., 2) of cells c: (..., 6, 2)."""
        xi = (x[..., 0] - cc[c, ..., 0]) / h[c, ...]
        et = (x[..., 1] - cc[c, ..., 1]) / h[c, ...]
        one = np.ones_like(xi)
        zero = np.zeros_like(xi)
        mx = np.stack([one, xi, et, zero, zero, zero], axis=-1)
        my = np.stack([zero, zero, zero, one, xi, et], axis=-1)
        return np.stack([mx, my], axis=-1)              # (..., 6, 2)

    # edge-moment Vandermonde: 2-pt Gauss on t in [0, 1] along lo->hi
    tg, wg = np.polynomial.legendre.leggauss(2)
    tg = 0.5 * (tg + 1.0)
    wg = 0.5 * wg
    V = np.zeros((nc, 6, 6))
    gdof = np.zeros((nc, 6), dtype=np.int64)
    osgn = np.zeros((nc, 3))
    carange = np.arange(nc)
    for k, (a, b) in enumerate(pairs):
        ga, gb = cells[:, a], cells[:, b]
        lo = np.minimum(ga, gb)
        hi = np.maximum(ga, gb)
        xlo, xhi = coords[lo], coords[hi]
        d = xhi - xlo                                   # (nc, 2)
        nun = np.stack([d[:, 1], -d[:, 0]], axis=1)     # right normal * |d|
        # outward sign of the global right normal w.r.t. this cell
        osgn[:, k] = np.sign(
            ((xlo + xhi) / 2 - cc) [:, 0] * nun[:, 0]
            + ((xlo + xhi) / 2 - cc)[:, 1] * nun[:, 1])
        xt = xlo[:, None] + tg[None, :, None] * d[:, None]  # (nc, ng, 2)
        mv = monos(xt, carange[:, None])                # (nc, ng, 6, 2)
        mn = np.einsum("cgjd,cd->cgj", mv, nun)         # sigma . n*|d|
        V[:, 2 * k] = np.einsum("g,cgj->cj", wg, mn)
        V[:, 2 * k + 1] = np.einsum("g,g,cgj->cj", wg, 2 * tg - 1, mn)
        gdof[:, 2 * k] = 2 * c2e[:, k]
        gdof[:, 2 * k + 1] = 2 * c2e[:, k] + 1
    C = np.linalg.inv(V)                                # (nc, 6, 6)
    # mass matrix (degree-2 exact): basis S_i = sum_j C[c, j, i] m_j
    qp, qw = stroud_conical_quadrature(2, 2)
    lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
    xq = np.einsum("qv,cvd->cqd", lam, v)               # (nc, nq, 2)
    mv = monos(xq, carange[:, None])                    # (nc, nq, 6, 2)
    S = np.einsum("cqjd,cji->cqid", mv, C)              # (nc, nq, 6, 2)
    wdet = qw[None, :] * np.abs(detJ)[:, None]
    Me = np.einsum("cq,cqid,cqjd->cij", wdet, S, S)
    rows = np.repeat(gdof, 6, axis=1).reshape(-1)
    cols = np.tile(gdof, (1, 6)).reshape(-1)
    M = sp.csr_matrix((Me.reshape(-1), (rows, cols)), shape=(2 * ne, 2 * ne))
    # div block: outward flux = sum of signed zeroth moments (exact)
    B = sp.csr_matrix(
        (osgn.reshape(-1),
         (np.repeat(np.arange(nc), 3), (2 * c2e).reshape(-1))),
        shape=(nc, 2 * ne))
    K = sp.bmat([[M, B.T], [B, None]], format="csr")
    rhs = np.zeros(2 * ne + nc)
    if np.isscalar(f):
        rhs[2 * ne:] = -float(f) * area
    else:
        rhs[2 * ne:] = -np.einsum("cq,cq->c", wdet,
                                  np.asarray([[float(f(x)) for x in row]
                                              for row in xq]))

    def eval_sigma(s):
        se = np.asarray(s)[gdof]                        # (nc, 6)
        sig = np.einsum("cqid,ci->cqd", S, se)
        return sig, xq, wdet

    return (MatAIJ.from_scipy(K, comm=plex.comm),
            _Vec.from_array(rhs, comm=plex.comm), 2 * ne, eval_sigma)


def rt1_mixed_poisson(plex, f=1.0):
    """Mixed Poisson with RT1 x P1disc on triangles — the next member of
    the H(div) Raviart-Thomas family (PETSCDUALSPACE RT at order 1,
    src/dm/dt/space/impls/ptrimmed/spaceptrimmed.c: the trimmed space
    (P1)^2 + x Ptilde_1, dim 8): both the flux AND the potential
    converge at O(h^2), one order above RT0 on each.

        (sigma, tau) + (u, div tau) = 0        for all tau in RT1
        (div sigma, v)             = -(f, v)   for all v in P1disc

    Same TPU-idiomatic construction as bdm1_mixed_poisson: per-cell 8x8
    generalized Vandermonde over centroid-centered monomial fields
    (6 P1 fields + the two trimmed fields xi*(xi,eta), eta*(xi,eta)),
    batched over all cells.  Dofs: 2 Legendre normal moments per edge
    (globally shared -> normal continuity) + 2 interior mean-value
    moments per cell.  div(RT1) = P1disc exactly, so the div block is
    integrated exactly by degree-2 quadrature.

    Returns (K MatAIJ, rhs Vec, nflux = 2*ne + 2*nc, eval_sigma,
    eval_u) with eval_u(s) -> (uh (nc, nq), xq, wdet)."""
    import scipy.sparse as sp
    from ..mat.aij import MatAIJ
    from ..vec.vec import Vec as _Vec
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    if cells.shape[1] != 3 or coords.shape[1] != 2:
        from ..sys.error import Error
        raise Error("rt1_mixed_poisson: 2-D triangle meshes only")
    edges, c2e = build_edges(cells)
    ne, nc = len(edges), len(cells)
    pairs = [(0, 1), (1, 2), (0, 2)]
    v = coords[cells]
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    cc = v.mean(axis=1)
    h = np.sqrt(area)
    carange = np.arange(nc)

    def monos(x, c):
        """8 RT1 monomial fields at points x (..., 2) of cells c:
        6 x P1 + the trimmed pair; returns (..., 8, 2)."""
        xi = (x[..., 0] - cc[c, ..., 0]) / h[c, ...]
        et = (x[..., 1] - cc[c, ..., 1]) / h[c, ...]
        one = np.ones_like(xi)
        zero = np.zeros_like(xi)
        mx = np.stack([one, xi, et, zero, zero, zero,
                       xi * xi, xi * et], axis=-1)
        my = np.stack([zero, zero, zero, one, xi, et,
                       xi * et, et * et], axis=-1)
        return np.stack([mx, my], axis=-1)

    def monos_div(x, c):
        """Divergence of the 8 fields at x: (..., 8)."""
        xi = (x[..., 0] - cc[c, ..., 0]) / h[c, ...]
        et = (x[..., 1] - cc[c, ..., 1]) / h[c, ...]
        one = np.ones_like(xi)
        zero = np.zeros_like(xi)
        hi = 1.0 / h[c, ...]
        return np.stack([zero, one * hi, zero, zero, zero, one * hi,
                         3 * xi * hi, 3 * et * hi], axis=-1)

    # dof rows: 6 edge moments (as BDM1) + 2 interior means
    tg, wg = np.polynomial.legendre.leggauss(2)
    tg = 0.5 * (tg + 1.0)
    wg = 0.5 * wg
    V = np.zeros((nc, 8, 8))
    gdof = np.zeros((nc, 8), dtype=np.int64)
    for k, (a, b) in enumerate(pairs):
        ga, gb = cells[:, a], cells[:, b]
        lo = np.minimum(ga, gb)
        hi_ = np.maximum(ga, gb)
        xlo, xhi = coords[lo], coords[hi_]
        d = xhi - xlo
        nun = np.stack([d[:, 1], -d[:, 0]], axis=1)
        xt = xlo[:, None] + tg[None, :, None] * d[:, None]
        mv = monos(xt, carange[:, None])                # (nc, ng, 8, 2)
        mn = np.einsum("cgjd,cd->cgj", mv, nun)
        V[:, 2 * k] = np.einsum("g,cgj->cj", wg, mn)
        V[:, 2 * k + 1] = np.einsum("g,g,cgj->cj", wg, 2 * tg - 1, mn)
        gdof[:, 2 * k] = 2 * c2e[:, k]
        gdof[:, 2 * k + 1] = 2 * c2e[:, k] + 1
    # interior dofs: cell-mean of each component (degree-2 quadrature)
    qp, qw = stroud_conical_quadrature(2, 3)
    lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
    xq = np.einsum("qv,cvd->cqd", lam, v)               # (nc, nq, 2)
    wdet = qw[None, :] * np.abs(detJ)[:, None]
    mq = monos(xq, carange[:, None])                    # (nc, nq, 8, 2)
    for d in range(2):
        V[:, 6 + d] = np.einsum("cq,cqj->cj", wdet, mq[..., d]) \
            / area[:, None]
        gdof[:, 6 + d] = 2 * ne + 2 * carange + d
    C = np.linalg.inv(V)                                # (nc, 8, 8)
    S = np.einsum("cqjd,cji->cqid", mq, C)              # basis at qp
    Me = np.einsum("cq,cqid,cqjd->cij", wdet, S, S)
    nflux = 2 * ne + 2 * nc
    rows = np.repeat(gdof, 8, axis=1).reshape(-1)
    cols = np.tile(gdof, (1, 8)).reshape(-1)
    M = sp.csr_matrix((Me.reshape(-1), (rows, cols)),
                      shape=(nflux, nflux))
    # div block against P1disc (3 dofs per cell, barycentric basis)
    dq = np.einsum("cqj,cji->cqi", monos_div(xq, carange[:, None]), C)
    Be = np.einsum("cq,cqi,qv->cvi", wdet, dq, lam)     # (nc, 3, 8)
    udof = (3 * carange[:, None] + np.arange(3))        # (nc, 3)
    Brows = np.repeat(udof, 8, axis=1).reshape(-1)
    Bcols = np.tile(gdof, (1, 3)).reshape(-1)
    B = sp.csr_matrix((Be.reshape(-1), (Brows, Bcols)),
                      shape=(3 * nc, nflux))
    K = sp.bmat([[M, B.T], [B, None]], format="csr")
    rhs = np.zeros(nflux + 3 * nc)
    if np.isscalar(f):
        fq = np.full((nc, len(qp)), float(f))
    else:
        fq = np.asarray([[float(f(x)) for x in row] for row in xq])
    rhs[nflux:] = -np.einsum("cq,cq,qv->cv", wdet, fq, lam).reshape(-1)

    def eval_sigma(s):
        se = np.asarray(s)[gdof]
        sig = np.einsum("cqid,ci->cqd", S, se)
        return sig, xq, wdet

    def eval_u(s):
        ue = np.asarray(s)[nflux + udof]                # (nc, 3)
        return np.einsum("qv,cv->cq", lam, ue), xq, wdet

    return (MatAIJ.from_scipy(K, comm=plex.comm),
            _Vec.from_array(rhs, comm=plex.comm), nflux,
            eval_sigma, eval_u)


def nedelec1_curlcurl(plex, alpha=1.0, beta=1.0):
    """H(curl) full-linear Nédélec (2nd kind, order 1) on triangles —
    the higher-order edge element named next to BDM1 in the dualspace
    family (it IS BDM1 rotated 90°: full P1 vector fields with 2
    tangential Legendre moments per edge).  Converges at O(h^2) in L2
    where the Whitney element (nedelec0_curlcurl) gives O(h).

    Assembles K = alpha (curl E, curl F) + beta (E, F) over the 2*ne
    edge-moment dofs, plus the interpolation machinery.  Returns
    (K MatAIJ, dofs, interpolate, eval_E) with
      dofs(E_exact) -> exact dof vector (for essential tangential BCs),
      eval_E(s) -> (Eh (nc, nq, 2), xq, wdet)."""
    import scipy.sparse as sp
    from ..mat.aij import MatAIJ
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    if cells.shape[1] != 3 or coords.shape[1] != 2:
        from ..sys.error import Error
        raise Error("nedelec1_curlcurl: 2-D triangle meshes only")
    edges, c2e = build_edges(cells)
    ne, nc = len(edges), len(cells)
    pairs = [(0, 1), (1, 2), (0, 2)]
    v = coords[cells]
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    cc = v.mean(axis=1)
    h = np.sqrt(area)
    carange = np.arange(nc)

    def monos(x, c):
        xi = (x[..., 0] - cc[c, ..., 0]) / h[c, ...]
        et = (x[..., 1] - cc[c, ..., 1]) / h[c, ...]
        one = np.ones_like(xi)
        zero = np.zeros_like(xi)
        mx = np.stack([one, xi, et, zero, zero, zero], axis=-1)
        my = np.stack([zero, zero, zero, one, xi, et], axis=-1)
        return np.stack([mx, my], axis=-1)

    # curls of the monomial fields: curl (mx, my) = dmy/dx - dmx/dy
    # (constants: [0, 0, -1/h, 0, 1/h, 0])
    tg, wg = np.polynomial.legendre.leggauss(2)
    tg = 0.5 * (tg + 1.0)
    wg = 0.5 * wg
    V = np.zeros((nc, 6, 6))
    gdof = np.zeros((nc, 6), dtype=np.int64)
    edge_pts = []       # per local edge: (xlo, d) for dof evaluation
    for k, (a, b) in enumerate(pairs):
        ga, gb = cells[:, a], cells[:, b]
        lo = np.minimum(ga, gb)
        hi = np.maximum(ga, gb)
        xlo, xhi = coords[lo], coords[hi]
        d = xhi - xlo                        # tangent * |e|, lo -> hi
        edge_pts.append((xlo, d))
        xt = xlo[:, None] + tg[None, :, None] * d[:, None]
        mv = monos(xt, carange[:, None])
        mt = np.einsum("cgjd,cd->cgj", mv, d)        # E . t*|e|
        V[:, 2 * k] = np.einsum("g,cgj->cj", wg, mt)
        V[:, 2 * k + 1] = np.einsum("g,g,cgj->cj", wg, 2 * tg - 1, mt)
        gdof[:, 2 * k] = 2 * c2e[:, k]
        gdof[:, 2 * k + 1] = 2 * c2e[:, k] + 1
    C = np.linalg.inv(V)
    qp, qw = stroud_conical_quadrature(2, 2)
    lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
    xq = np.einsum("qv,cvd->cqd", lam, v)
    wdet = qw[None, :] * np.abs(detJ)[:, None]
    mq = monos(xq, carange[:, None])
    S = np.einsum("cqjd,cji->cqid", mq, C)
    Mass = np.einsum("cq,cqid,cqjd->cij", wdet, S, S)
    curl_m = np.stack([np.zeros(nc), np.zeros(nc), -1.0 / h,
                       np.zeros(nc), 1.0 / h, np.zeros(nc)], axis=1)
    curl_b = np.einsum("cj,cji->ci", curl_m, C)          # (nc, 6)
    # constant curls -> the curl-curl block integrates exactly to
    # area * curl_i curl_j
    Kc = np.einsum("ci,cj,c->cij", curl_b, curl_b, area)
    Ke = alpha * Kc + beta * Mass
    rows = np.repeat(gdof, 6, axis=1).reshape(-1)
    cols = np.tile(gdof, (1, 6)).reshape(-1)
    K = sp.csr_matrix((Ke.reshape(-1), (rows, cols)),
                      shape=(2 * ne, 2 * ne))

    def dofs(E):
        """Exact dof vector of a smooth field E(x) -> (2,): the global
        tangential Legendre moments (for BCs / interpolation)."""
        out = np.zeros(2 * ne)
        xlo = coords[edges.min(axis=1)]
        d = coords[edges.max(axis=1)] - xlo
        xt = xlo[:, None] + tg[None, :, None] * d[:, None]  # (ne, g, 2)
        Et = np.einsum("egd,ed->eg",
                       np.asarray([[E(x) for x in row] for row in xt]), d)
        out[0::2] = np.einsum("g,eg->e", wg, Et)
        out[1::2] = np.einsum("g,g,eg->e", wg, 2 * tg - 1, Et)
        return out

    def eval_E(s):
        se = np.asarray(s)[gdof]
        return np.einsum("cqid,ci->cqd", S, se), xq, wdet

    return (MatAIJ.from_scipy(K, comm=plex.comm), dofs, eval_E,
            edges)


def nedelec0_curlcurl(plex, alpha=1.0, beta=1.0):
    """H(curl) lowest-order Nédélec (edge) elements on triangles — the
    PETSCDUALSPACE Nédélec role: Whitney 1-forms
    W_ab = lambda_a grad(lambda_b) - lambda_b grad(lambda_a), mapped
    covariantly (J^{-T}), dof = tangential circulation along the global
    low->high edge direction. Assembles the definite Maxwell operator

        K = alpha * (curl E, curl F) + beta * (E, F)

    and the discrete gradient G (P1 nodes -> edges, the signed node-edge
    incidence), which satisfies the exact-sequence identity
    curl o grad = 0: the curl part of K annihilates G v for every nodal
    v — the discrete de Rham complex property that makes edge elements
    spurious-mode free. Returns (K MatAIJ, G scipy, edges)."""
    import scipy.sparse as sp
    from ..mat.aij import MatAIJ
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    if cells.shape[1] != 3 or coords.shape[1] != 2:
        from ..sys.error import Error
        raise Error("nedelec0_curlcurl: 2-D triangle meshes only")
    edges, c2e = build_edges(cells)
    ne, nc = len(edges), len(cells)
    pairs = [(0, 1), (1, 2), (0, 2)]
    v = coords[cells]
    J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = np.abs(detJ) / 2.0
    # physical P1 gradients (nc, 3, 2)
    from .plex import _p1_cell_gradients
    g, vol = _p1_cell_gradients(coords, cells, 2)
    # orientation: dof is circulation along the global low->high direction
    sgn = np.stack([np.where(cells[:, a] < cells[:, b], 1.0, -1.0)
                    for a, b in pairs], axis=1)
    # curl W_ab = 2 grad(lambda_a) x grad(lambda_b) (constant per cell)
    curl = np.stack([2.0 * (g[:, a, 0] * g[:, b, 1]
                            - g[:, a, 1] * g[:, b, 0])
                     for a, b in pairs], axis=1) * sgn     # (nc, 3)
    Kcurl = np.einsum("ci,cj,c->cij", curl, curl, area)
    # mass: integrate W_i . W_j with degree-2 quadrature in barycentric
    qp, qw = stroud_conical_quadrature(2, 2)
    lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
    W = np.stack([lam[:, a][None, :, None] * g[:, None, b, :]
                  - lam[:, b][None, :, None] * g[:, None, a, :]
                  for a, b in pairs])                       # (3, nc, nq, 2)
    Mass = np.einsum("icqd,jcqd,q,c->cij", W, W, qw, 2 * area) \
        * (sgn[:, :, None] * sgn[:, None, :])
    Ke = alpha * Kcurl + beta * Mass
    rows = np.repeat(c2e, 3, axis=1).reshape(-1)
    cols = np.tile(c2e, (1, 3)).reshape(-1)
    K = sp.csr_matrix((Ke.reshape(-1), (rows, cols)), shape=(ne, ne))
    # discrete gradient: (G v)_e = v[hi] - v[lo] (circulation of grad v)
    nv = len(coords)
    G = sp.csr_matrix(
        (np.concatenate([np.ones(ne), -np.ones(ne)]),
         (np.concatenate([np.arange(ne), np.arange(ne)]),
          np.concatenate([edges.max(axis=1), edges.min(axis=1)]))),
        shape=(ne, nv))
    return MatAIJ.from_scipy(K, comm=plex.comm), G, edges


def _det_small(J):
    """Closed-form determinant for (..., d, d), d in {1,2,3} (the
    reference's form, which also keeps torch.linalg out of the batched
    element kernel)."""
    d = J.shape[-1]
    if d == 1:
        return J[..., 0, 0]
    if d == 2:
        return (J[..., 0, 0] * J[..., 1, 1]
                - J[..., 0, 1] * J[..., 1, 0])
    return (J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2]
                            - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2]
                              - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1]
                              - J[..., 1, 1] * J[..., 2, 0]))


def _inv_small(J, det=None):
    """Adjugate inverse for (..., d, d), d in {1,2,3}."""
    d = J.shape[-1]
    det = _det_small(J) if det is None else det
    if d == 1:
        return (1.0 / det)[..., None, None]
    if d == 2:
        adj = torch.stack([
            torch.stack([J[..., 1, 1], -J[..., 0, 1]], dim=-1),
            torch.stack([-J[..., 1, 0], J[..., 0, 0]], dim=-1)], dim=-2)
        return adj / det[..., None, None]
    c = torch.stack
    adj = c([
        c([J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1],
           J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2],
           J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]],
          dim=-1),
        c([J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2],
           J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0],
           J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]],
          dim=-1),
        c([J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0],
           J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1],
           J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]],
          dim=-1)], dim=-2)
    return adj / det[..., None, None]


def _pointwise(fn, zero_like):
    """A user pointwise function whose result is always a tensor (a
    constant result, such as the default 0.0, becomes one shaped as the
    zero it stands in for)."""
    def f(u, gu, x):
        r = fn(u, gu, x)
        if isinstance(r, torch.Tensor):
            return r
        return torch.zeros_like(zero_like(x)) + r
    return f


def host_array(u):
    """u (a Vec, tensor or array) as a float64 numpy array."""
    if hasattr(u, "getArray"):
        u = u.getArray()
    if isinstance(u, torch.Tensor):
        return u.detach().cpu().numpy().astype(np.float64)
    return np.asarray(u, dtype=np.float64)


def _as_device(u, n, device, dtype):
    """The first n entries of u (a Vec, tensor or array) as a contiguous
    tensor on `device`."""
    if hasattr(u, "getArray"):
        u = u.getArray()
    t = torch.as_tensor(u, dtype=dtype, device=device) if not isinstance(u, torch.Tensor) \
        else u.to(device=device, dtype=dtype)
    return t.reshape(-1)[:n].contiguous()


class DS:
    """PetscDS role: assemble residual/Jacobian from pointwise weak forms

        F_v = sum_q w_q |J| [ f0(u, gu, x) B[q,v] + f1(u, gu, x) . gD[q,v] ]

    with f0 scalar and f1 a dim-vector, both torch functions of one
    quadrature point (u, gu, x: a scalar, (dim,), (dim,); for ncomp > 1
    (ncomp,), (ncomp, dim), (dim,)). The element kernel is batched over the
    cells; the element Jacobian is the forward-mode derivative of the SAME
    kernel. Device tables (the gather index, X1's scatter table and the
    per-cell geometry) are built once per device, at the first assembly."""

    def __init__(self, plex, fe: FE):
        self.fe = fe
        self._plex = plex
        self.cells = np.asarray(plex.cells, dtype=np.int64)
        self.coords = np.asarray(plex.coords, dtype=np.float64)
        self.ncomp = getattr(fe, "ncomp", 1)
        nv = len(self.coords)
        if getattr(fe, "order", None) is not None:
            # generic Lagrange path (any order/dim/cell, vector fields)
            conn, nn, dof_xy = build_dof_layout(self.cells, self.coords, fe)
            self.node_conn = conn
            self.ndof = nn * self.ncomp
            self.dof_coords = dof_xy
            if self.ncomp == 1:
                self.conn = conn
            else:
                nc = self.ncomp
                self.conn = (conn[:, :, None] * nc
                             + np.arange(nc)).reshape(len(conn), -1)
        elif fe.dof_kind == "facet":
            # Crouzeix-Raviart: one dof (x ncomp) per edge midpoint
            self.edges, c2e = build_edges(self.cells)
            self.node_conn = c2e
            self.ndof = len(self.edges) * self.ncomp
            self.dof_coords = 0.5 * (self.coords[self.edges[:, 0]]
                                     + self.coords[self.edges[:, 1]])
            if self.ncomp == 1:
                self.conn = c2e
            else:
                nc_ = self.ncomp
                self.conn = (c2e[:, :, None] * nc_
                             + np.arange(nc_)).reshape(len(c2e), -1)
        elif fe.dof_kind == "vertex+edge":
            self.edges, c2e = build_edges(self.cells)
            self.conn = np.concatenate([self.cells, nv + c2e], axis=1)
            self.node_conn = self.conn
            self.ndof = nv + len(self.edges)
            # P2 node coordinates (vertices + midpoints) for BC detection
            mids = 0.5 * (self.coords[self.edges[:, 0]]
                          + self.coords[self.edges[:, 1]])
            self.dof_coords = np.vstack([self.coords, mids])
        elif fe.dof_kind == "cell":
            # discontinuous cellwise dofs (P0disc): one (x ncomp) per cell
            nc_cells = len(self.cells)
            conn = np.arange(nc_cells, dtype=np.int64)[:, None]
            self.node_conn = conn
            self.ndof = nc_cells * self.ncomp
            self.dof_coords = self.coords[self.cells].mean(axis=1)
            if self.ncomp == 1:
                self.conn = conn
            else:
                self.conn = (conn[:, :, None] * self.ncomp
                             + np.arange(self.ncomp)).reshape(nc_cells, -1)
        else:
            self.conn = self.cells
            self.node_conn = self.cells
            self.ndof = nv
            self.dof_coords = self.coords
        self.f0 = None
        self.f1 = None
        self._f0_bd = None
        self._dev = {}
        self._bd_tables = None
        self._coo = None          # assembleJacobianCOO's plan
        # high-order geometry: curved P2 coordinate field attached by
        # DMPlex.curveBoundary (2-D simplex cells)
        self._p2_geom = None
        pg = getattr(plex, "p2_geom", None)
        if pg is not None and getattr(fe, "cell", "simplex") == "simplex" \
                and fe.dim == 2:
            self._p2_geom = (np.asarray(pg[0], dtype=np.int64),
                             np.asarray(pg[1], dtype=np.float64))
            # dof coordinates through the curved map (BC detection and
            # nodal-error evaluation on the true geometry)
            if getattr(fe, "order", None) is not None:
                refn = np.asarray(fe.nodes)
            elif fe.dof_kind == "vertex+edge":      # P2: verts + midpts
                refn = np.array([[0., 0.], [1., 0.], [0., 1.],
                                 [.5, 0.], [.5, .5], [0., .5]])
            elif fe.dof_kind == "facet":            # CR: edge midpoints
                refn = np.array([[.5, 0.], [.5, .5], [0., .5]])
            else:                                   # vertex dofs already
                refn = None                         # lie on the geometry
            if refn is not None:
                Bn, _ = _geom_p2_tri(refn)
                phys = np.einsum("bv,cvd->cbd", Bn,
                                 self._p2_geom[1][self._p2_geom[0]])
                dc = np.array(self.dof_coords)
                dc[self.node_conn.reshape(-1)] = \
                    phys.reshape(-1, 2)
                self.dof_coords = dc

    def _cell_geom_coords_host(self):
        """Per-cell geometry node coordinates (host): straight corner
        coords or the curved P2 coordinate field."""
        if self._p2_geom is not None:
            conn2, coords2 = self._p2_geom
            return coords2[conn2]
        return self.coords[self.cells]

    def _affine(self):
        return getattr(self.fe, "cell", "simplex") == "simplex" and self._p2_geom is None

    def setResidual(self, f0=None, f1=None):
        """f0(u, gu, x) -> scalar; f1(u, gu, x) -> (dim,) vector."""
        self.f0 = f0
        self.f1 = f1
        return self

    # ---- device tables, built once per device ----

    def _tables(self):
        dev, dt = config.device(), config.real_dtype()
        key = (str(dev), dt)
        tab = self._dev.get(key)
        if tab is not None:
            return tab
        fe, dim = self.fe, self.fe.dim
        qp = np.asarray(fe.qp)
        nq = len(qp)
        xe = torch.as_tensor(self._cell_geom_coords_host(), dtype=dt, device=dev)
        if self._affine():
            # affine simplex: one J per cell
            J = torch.stack([xe[:, i + 1] - xe[:, 0] for i in range(dim)], dim=2)
            dj = _det_small(J)
            Jinv = _inv_small(J, dj)                             # (nc, d, d)
            lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
            lam = torch.as_tensor(lam, dtype=dt, device=dev)
            xq = torch.einsum("qv,cvd->cqd", lam, xe[:, : dim + 1])
            detJ = torch.abs(dj)[:, None].expand(-1, nq)
        else:
            if self._p2_geom is not None:
                Bg, Dg = _geom_p2_tri(qp)
            elif getattr(fe, "cell", None) == "prism":
                Bg, Dg = _geom_prism(qp)
            else:
                Bg, Dg = _geom_tabulation(dim, qp)
            Bg = torch.as_tensor(Bg, dtype=dt, device=dev)
            Dg = torch.as_tensor(Dg, dtype=dt, device=dev)
            # J[c,q,e,d] = dx_e/dxi_d = sum_v Dg[q,v,d] xe[c,v,e]
            J = torch.einsum("qvd,cve->cqed", Dg, xe)
            dj = _det_small(J)
            detJ = torch.abs(dj)
            Jinv = _inv_small(J, dj)                             # (nc, q, d, e)
            xq = torch.einsum("qv,cvd->cqd", Bg, xe)
        qw = torch.as_tensor(np.asarray(fe.qw), dtype=dt, device=dev)
        conn = np.asarray(self.conn, dtype=np.int64)
        nc, nb = conn.shape
        tab = {
            "B": torch.as_tensor(np.asarray(fe.B), dtype=dt, device=dev),
            "D": torch.as_tensor(np.asarray(fe.D), dtype=dt, device=dev),
            "Jinv": Jinv.contiguous(), "wdet": (qw * detJ).contiguous(),
            "xq": xq.contiguous(),
            "conn": torch.as_tensor(conn.reshape(-1).astype(np.int32), device=dev),
            # X1: the residual's scatter-add, entries in conn's order
            "scatter": scatter_table(conn.reshape(-1), np.arange(nc * nb), self.ndof,
                                     nc * nb, device=dev, dtype=dt),
        }
        self._dev[key] = tab
        return tab

    def _gather_elements(self, u, tab):
        ut = _as_device(u, self.ndof, tab["B"].device, tab["B"].dtype)
        return gather(ut, tab["conn"], check=False).reshape(len(self.conn), -1)

    def _element_kernel(self):
        """The element residual batched over cells: element(ue (nc, nb*ncomp),
        Jinv, wdet (nc, nq), xq (nc, nq, dim)) -> (nc, nb*ncomp)."""
        fe = self.fe
        dim = fe.dim
        ncmp = self.ncomp
        affine = self._affine()
        if ncmp == 1:
            f0 = _pointwise(self.f0 or (lambda u, gu, x: 0.0), lambda x: x[0])
            f1 = _pointwise(self.f1 or (lambda u, gu, x: 0.0), lambda x: x)
        else:
            f0 = _pointwise(self.f0 or (lambda u, gu, x: 0.0),
                            lambda x: x.new_zeros(ncmp))
            f1 = _pointwise(self.f1 or (lambda u, gu, x: 0.0),
                            lambda x: x.new_zeros(ncmp, dim))
        vf0 = torch.func.vmap(f0)
        vf1 = torch.func.vmap(f1)

        def element(ue, B, D, Jinv, wdet, xq):
            nc, nq = wdet.shape
            gD = torch.einsum("qbd,cde->cqbe", D, Jinv) if affine \
                else torch.einsum("qbd,cqde->cqbe", D, Jinv)      # phys gradients
            xf = xq.reshape(nc * nq, dim)
            if ncmp == 1:
                uq = torch.einsum("qb,cb->cq", B, ue)
                guq = torch.einsum("cqbe,cb->cqe", gD, ue)
                f0q = vf0(uq.reshape(-1), guq.reshape(-1, dim), xf).reshape(nc, nq)
                f1q = vf1(uq.reshape(-1), guq.reshape(-1, dim), xf).reshape(nc, nq, dim)
                return torch.einsum("cq,qv->cv", wdet * f0q, B) \
                    + torch.einsum("cq,cqe,cqve->cv", wdet, f1q, gD)
            un = ue.reshape(nc, fe.nb, ncmp)
            uq = torch.einsum("qb,cbk->cqk", B, un)
            guq = torch.einsum("cqbe,cbk->cqke", gD, un)
            f0q = vf0(uq.reshape(-1, ncmp), guq.reshape(-1, ncmp, dim), xf) \
                .reshape(nc, nq, ncmp)
            f1q = vf1(uq.reshape(-1, ncmp), guq.reshape(-1, ncmp, dim), xf) \
                .reshape(nc, nq, ncmp, dim)
            Fv = torch.einsum("cq,cqk,qv->cvk", wdet, f0q, B) \
                + torch.einsum("cq,cqke,cqve->cvk", wdet, f1q, gD)
            return Fv.reshape(nc, -1)

        return element

    def elementResiduals(self, u):
        """The element residuals (nc, nb*ncomp) on the device."""
        tab = self._tables()
        ue = self._gather_elements(u, tab)
        return self._element_kernel()(ue, tab["B"], tab["D"], tab["Jinv"], tab["wdet"],
                                      tab["xq"])

    def elementJacobians(self, u):
        """The element Jacobians (nc, nb*ncomp, nb*ncomp) on the device:
        column j is the jvp of the element kernel along element dof j."""
        tab = self._tables()
        ue = self._gather_elements(u, tab)
        element = self._element_kernel()
        nbk = ue.shape[1]
        args = (tab["B"], tab["D"], tab["Jinv"], tab["wdet"], tab["xq"])

        def column(t):
            return torch.func.jvp(lambda v: element(v, *args), (ue,), (t,))[1]

        basis = torch.eye(nbk, dtype=ue.dtype, device=ue.device)[:, None, :] \
            .expand(nbk, ue.shape[0], nbk)
        cols = torch.func.vmap(column)(basis)                  # (j, nc, i)
        return cols.permute(1, 2, 0).contiguous()

    def assembleResidual(self, u):
        """Global residual F(u) (no boundary conditions applied), a tensor
        on the device."""
        tab = self._tables()
        F = dst_scatter(tab["scatter"], self.elementResiduals(u).reshape(-1).contiguous())
        if self._f0_bd is not None:
            F = F + self._bd_residual(u)
        return F

    def l2_error(self, u, exact):
        """Quadrature L2 error ||u_h - exact||_0 through the element
        geometry (straight, multilinear, prism, or curved P2) —
        DMPlexComputeL2DiffLocal role (host numpy, as the reference)."""
        fe = self.fe
        qp = np.asarray(fe.qp)
        B = np.asarray(fe.B)
        xe = self._cell_geom_coords_host()
        dim = fe.dim
        if self._p2_geom is not None:
            Bg, Dg = _geom_p2_tri(qp)
        elif getattr(fe, "cell", "simplex") == "simplex":
            lam = np.concatenate(
                [1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
            Bg = lam
            Dg = None
        elif getattr(fe, "cell", None) == "prism":
            Bg, Dg = _geom_prism(qp)
        else:
            Bg, Dg = _geom_tabulation(dim, qp)
        if Dg is None:
            J = np.stack([xe[:, i + 1] - xe[:, 0] for i in range(dim)],
                         axis=2)
            detJ = np.abs(np.linalg.det(J))[:, None] \
                * np.ones((1, len(qp)))
            xq = np.einsum("qv,cvd->cqd", Bg, xe[:, : dim + 1])
        else:
            J = np.einsum("qvd,cve->cqed", Dg, xe)
            detJ = np.abs(np.linalg.det(J))
            xq = np.einsum("qv,cvd->cqd", Bg, xe)
        uh = host_array(u)
        if self.ncomp == 1:
            ue = uh[self.node_conn]                      # (ncell, nb)
            uq = np.einsum("qb,cb->cq", B, ue)
            ex = np.asarray([[float(exact(x)) for x in row] for row in xq])
            err2 = (uq - ex) ** 2
        else:
            # dofs interleave node*ncomp+c: reshape to (nnode, ncomp) and
            # sum component errors; exact(x) must return (ncomp,)
            un = uh[: self.ndof].reshape(-1, self.ncomp)
            ue = un[self.node_conn]                      # (ncell, nb, k)
            uq = np.einsum("qb,cbk->cqk", B, ue)
            ex = np.asarray([[np.asarray(exact(x), dtype=np.float64)
                              for x in row] for row in xq])
            err2 = ((uq - ex) ** 2).sum(axis=-1)
        wdet = np.asarray(fe.qw)[None, :] * detJ
        return float(np.sqrt((wdet * err2).sum()))

    def assembleJacobian(self, u):
        """Global sparse Jacobian dF/du (a scipy CSR, as the reference's),
        from the element Jacobians (exact tangent of the registered weak
        form)."""
        import scipy.sparse as sp
        Ke = host_array(self.elementJacobians(u))
        conn = self.conn
        nb = conn.shape[1]
        rows = np.repeat(conn, nb, axis=1).reshape(-1)
        cols = np.tile(conn, (1, nb)).reshape(-1)
        A = sp.csr_matrix((Ke.reshape(-1), (rows, cols)),
                          shape=(self.ndof, self.ndof))
        A.sum_duplicates()
        if self._f0_bd is not None:
            A = (A + self._bd_jacobian(u)).tocsr()
        return A

    def jacobianCOO(self, bnd=None):
        """The Jacobian's pattern with Dirichlet rows `bnd` made identity
        and their columns removed from the other rows (not stored as
        zeros), as the reference's scipy callback leaves it: (rows, cols)
        of the distinct entries in (row, col) order, and (slot, take) of
        the contributions: the element Jacobians' kept entries (flattened
        index take, in cell order) and each Dirichlet row's 1.0 (take =
        the entry count: the one after the element entries), each into its
        entry's slot."""
        conn = self.conn
        nb = conn.shape[1]
        rows = np.repeat(conn, nb, axis=1).reshape(-1)
        cols = np.tile(conn, (1, nb)).reshape(-1)
        isb = np.zeros(self.ndof, dtype=bool)
        if bnd is not None:
            isb[np.asarray(bnd, dtype=np.int64)] = True
        keep = np.flatnonzero(~isb[rows] & ~isb[cols])
        bd = np.flatnonzero(isb)
        r = np.concatenate([rows[keep], bd])
        c = np.concatenate([cols[keep], bd])
        take = np.concatenate([keep, np.full(len(bd), len(rows))])
        code = r * self.ndof + c
        uniq, slot = np.unique(code, return_inverse=True)
        return uniq // self.ndof, uniq % self.ndof, slot.reshape(-1), take

    def assembleJacobianCOO(self, u, P, bnd=None, Ke=None):
        """The Jacobian into the MatAIJ P on the device, pattern as
        jacobianCOO says: the distinct (row, col) pairs fixed by
        setPreallocationCOO (which keeps its plan when given the same
        pattern again), each entry's contributions summed by X1 (add mode,
        in cell order) from the element Jacobians and the identity's 1.0,
        then setValuesCOO (one K8 gather and the diagonal's). Ke: the
        element Jacobians at u where the caller has them. The values are
        assembleJacobian's with the Dirichlet rows and columns as
        jacobianCOO says."""
        if self._f0_bd is not None:
            raise NotImplementedError("assembleJacobianCOO: boundary-integral forms "
                                      "assemble through assembleJacobian")
        plan = self._coo
        bkey = np.zeros(0, dtype=np.int64) if bnd is None else np.asarray(bnd, dtype=np.int64)
        if plan is None or plan["dev"] != str(config.device()) \
                or not np.array_equal(plan["bnd"], bkey):
            rows, cols, slot, take = self.jacobianCOO(bkey)
            ne = self.conn.shape[0] * self.conn.shape[1] ** 2
            plan = {"bnd": bkey, "dev": str(config.device()), "rows": rows, "cols": cols,
                    "sum": scatter_table(slot, take, len(rows), ne + 1, device=config.device(),
                                         dtype=config.real_dtype())}
            self._coo = plan
        Ke = (self.elementJacobians(u) if Ke is None else Ke).reshape(-1)
        vals = dst_scatter(plan["sum"], torch.cat([Ke, Ke.new_ones(1)]))
        P.setPreallocationCOO(plan["rows"], plan["cols"])
        P.setValuesCOO(vals)
        return P

    def assembleJacobianDistributed(self, u, comm, bnd=None):
        """Per-shard weak-form Jacobian assembly into a distributed
        MPIAIJ: ROADMAP queue 1 item 12."""
        from ..sys.error import Error
        raise Error("DS.assembleJacobianDistributed comes with ROADMAP queue 1 item 12 "
                    "(distribution over several cards)")

    def assembleResidualDistributed(self, u, comm, bnd=None, bnd_values=0.0):
        """Per-shard residual on a distributed plex: ROADMAP queue 1 item 12."""
        from ..sys.error import Error
        raise Error("DS.assembleResidualDistributed comes with ROADMAP queue 1 item 12 "
                    "(distribution over several cards)")

    def boundary_dofs(self, predicate, comp=None):
        """Dof ids whose node coordinates satisfy predicate(x)
        (DMAddBoundary essential-BC role). For vector fields, restrict to
        component(s) `comp` (default: all components of matching nodes)."""
        mask = np.asarray([bool(predicate(x)) for x in self.dof_coords])
        nodes = np.where(mask)[0]
        if self.ncomp == 1:
            return nodes
        comps = (np.arange(self.ncomp) if comp is None
                 else np.atleast_1d(comp))
        return (nodes[:, None] * self.ncomp + comps).reshape(-1)

    # ---- boundary-integral (natural BC) weak forms ----

    def setBdResidual(self, f0_bd, predicate=None):
        """PetscDSAddBoundary NATURAL role (plexfem.c boundary-integral
        assembly): add the facet term

            F_v += sum_facets sum_q w_q |Jf| f0_bd(u, x, n) B_f[q, v]

        over boundary facets (optionally only those whose CENTROID
        satisfies `predicate(x)`), with n the outward unit normal.
        Neumann flux g: f0_bd = lambda u, x, n: -g(x); Robin
        alpha u + du/dn = g: f0_bd = lambda u, x, n: alpha*u - g(x).
        Supported elements: P1 simplex (2-D/3-D) and P2 triangles;
        scalar or vector (f0_bd returns (ncomp,))."""
        self._f0_bd = f0_bd
        self._bd_predicate = predicate
        self._bd_tables = None
        return self

    def _facet_tables(self):
        """(fconn, fxq, fw, fn, fB, X1 table): facet dof connectivity,
        quadrature points (physical), weights x |Jf|, outward unit normals,
        facet basis tabulation, on the device."""
        from ..sys.error import Error
        if self._bd_tables is not None:
            return self._bd_tables
        fe, dim = self.fe, self.fe.dim
        cells = self.cells
        nvl = cells.shape[1]
        if dim == 2 and nvl == 3:
            fac = [[0, 1], [1, 2], [2, 0]]
        elif dim == 3 and nvl == 4:
            fac = [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]
        else:
            raise Error("setBdResidual: simplex meshes only")
        # boundary facets with their parent cell
        allf = np.concatenate([np.sort(cells[:, f], axis=1) for f in fac])
        owner = np.tile(np.arange(len(cells)), len(fac))
        uniq, idx, counts = np.unique(allf, axis=0, return_index=True,
                                      return_counts=True)
        bsel = counts == 1
        bfac = uniq[bsel]                      # (nf, dim) vertex ids
        bcell = owner[idx[bsel]]
        # facet quadrature + geometry
        x = self.coords[bfac]                  # (nf, dim, dim)
        cc = self.coords[cells[bcell]].mean(axis=1)   # cell centroids
        if dim == 2:
            t, w = np.polynomial.legendre.leggauss(2)
            tq = 0.5 * (t + 1.0)
            wq = 0.5 * w
            e = x[:, 1] - x[:, 0]
            length = np.linalg.norm(e, axis=1)
            nrm = np.stack([e[:, 1], -e[:, 0]], axis=1) / length[:, None]
            flip = np.einsum("fe,fe->f",
                             x.mean(axis=1) - cc, nrm) < 0
            nrm[flip] *= -1.0
            fxq = (x[:, None, 0] * (1 - tq)[None, :, None]
                   + x[:, None, 1] * tq[None, :, None])  # (nf, nq, 2)
            fw = wq[None, :] * length[:, None]
            shp1 = np.stack([1 - tq, tq], axis=1)        # (nq, 2) P1
            if fe.dof_kind == "vertex+edge":             # P2 edge trace
                fB = np.stack([(1 - tq) * (1 - 2 * tq),
                               tq * (2 * tq - 1),
                               4 * tq * (1 - tq)], axis=1)  # (nq, 3)
                ekey = {tuple(sorted(e_)): i
                        for i, e_ in enumerate(map(tuple, self.edges))}
                nv = len(self.coords)
                mids = np.asarray([nv + ekey[tuple(sorted(f))]
                                   for f in bfac])
                fconn = np.concatenate([bfac, mids[:, None]], axis=1)
            elif fe.dof_kind == "vertex" or fe.nb == dim + 1:
                fB, fconn = shp1, bfac
            else:
                raise Error("setBdResidual: P1/P2 Lagrange only")
        else:
            # 3-pt edge-midpoint rule on the reference triangle facet
            lam = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                            [0.5, 0.0, 0.5]])
            wq = np.full(3, 1.0 / 3.0)
            e1 = x[:, 1] - x[:, 0]
            e2 = x[:, 2] - x[:, 0]
            cr = np.cross(e1, e2)
            area = 0.5 * np.linalg.norm(cr, axis=1)
            nrm = cr / np.linalg.norm(cr, axis=1)[:, None]
            flip = np.einsum("fe,fe->f", x.mean(axis=1) - cc, nrm) < 0
            nrm[flip] *= -1.0
            fxq = np.einsum("qv,fvd->fqd", lam, x)
            fw = wq[None, :] * area[:, None]
            if not (fe.dof_kind == "vertex" or fe.nb == dim + 1):
                raise Error("setBdResidual 3-D: P1 tets only")
            fB, fconn = lam, bfac
        if self._bd_predicate is not None:
            keep = np.asarray([bool(self._bd_predicate(c))
                               for c in fxq.mean(axis=1)])
            fconn, fxq, fw, nrm = (fconn[keep], fxq[keep], fw[keep],
                                   nrm[keep])
        if self.ncomp > 1:
            fconn = (fconn[:, :, None] * self.ncomp
                     + np.arange(self.ncomp)).reshape(len(fconn), -1)
        dev, dt = config.device(), config.real_dtype()
        fconn = np.asarray(fconn, dtype=np.int64)
        self._bd_tables = (
            fconn, torch.as_tensor(fconn.reshape(-1).astype(np.int32), device=dev),
            torch.as_tensor(fxq, dtype=dt, device=dev), torch.as_tensor(fw, dtype=dt, device=dev),
            torch.as_tensor(nrm, dtype=dt, device=dev), torch.as_tensor(fB, dtype=dt, device=dev),
            scatter_table(fconn.reshape(-1), np.arange(fconn.size), self.ndof, fconn.size,
                          device=dev, dtype=dt))
        return self._bd_tables

    def _bd_element_kernel(self):
        """The facet residual batched over facets: (ue (nf, nbf*ncomp), xq
        (nf, nq, dim), w (nf, nq), n (nf, dim)) -> (nf, nbf*ncomp)."""
        f0 = self._f0_bd
        ncmp = self.ncomp
        fB = self._facet_tables()[5]
        vf = torch.func.vmap(lambda u, x, n: _bd_value(f0(u, x, n), u))

        def felement(ue, xq, w, n):
            nf, nq = w.shape
            dim = xq.shape[-1]
            nrep = n[:, None, :].expand(nf, nq, dim).reshape(-1, dim)
            if ncmp == 1:
                uq = torch.einsum("qv,fv->fq", fB, ue)
                fq = vf(uq.reshape(-1), xq.reshape(-1, dim), nrep).reshape(nf, nq)
                return torch.einsum("fq,qv->fv", w * fq, fB)
            un = ue.reshape(nf, -1, ncmp)
            uq = torch.einsum("qv,fvk->fqk", fB, un)
            fq = vf(uq.reshape(-1, ncmp), xq.reshape(-1, dim), nrep).reshape(nf, nq, ncmp)
            return torch.einsum("fq,fqk,qv->fvk", w, fq, fB).reshape(nf, -1)

        return felement

    def _bd_gather(self, u):
        fconn, fidx = self._facet_tables()[:2]
        ut = _as_device(u, self.ndof, fidx.device, config.real_dtype())
        return gather(ut, fidx, check=False).reshape(fconn.shape)

    def _bd_residual(self, u):
        fconn, _, fxq, fw, fn, _, tab = self._facet_tables()
        if fconn.shape[0] == 0:
            return torch.zeros(self.ndof, dtype=config.real_dtype(), device=config.device())
        Fe = self._bd_element_kernel()(self._bd_gather(u), fxq, fw, fn)
        return dst_scatter(tab, Fe.reshape(-1).contiguous())

    def _bd_jacobian(self, u):
        import scipy.sparse as sp
        fconn, _, fxq, fw, fn, _, _ = self._facet_tables()
        if fconn.shape[0] == 0:
            return sp.csr_matrix((self.ndof, self.ndof))
        fel = self._bd_element_kernel()
        ue = self._bd_gather(u)
        nbk = ue.shape[1]

        def column(t):
            return torch.func.jvp(lambda v: fel(v, fxq, fw, fn), (ue,), (t,))[1]

        basis = torch.eye(nbk, dtype=ue.dtype, device=ue.device)[:, None, :] \
            .expand(nbk, ue.shape[0], nbk)
        Ke = host_array(torch.func.vmap(column)(basis).permute(1, 2, 0))
        nb = fconn.shape[1]
        rows = np.repeat(fconn, nb, axis=1).reshape(-1)
        cols = np.tile(fconn, (1, nb)).reshape(-1)
        A = sp.csr_matrix((Ke.reshape(-1), (rows, cols)),
                          shape=(self.ndof, self.ndof))
        A.sum_duplicates()
        return A


def _bd_value(r, u):
    """A boundary pointwise result as a tensor shaped as u's point value."""
    if isinstance(r, torch.Tensor):
        return r
    return torch.zeros_like(u) + r


def cr_cell_gradients(coords, cells):
    """Cellwise-constant CR basis gradients: grad phi_k = -2 grad
    lambda_opp(k), with opp matching build_edges' local pair order
    (01, 12, 02) -> opposite vertices (2, 0, 1). Single source of the
    edge-ordering convention for crouzeix_raviart_fe and
    cr_stokes_system."""
    from .plex import _p1_cell_gradients
    g, vol = _p1_cell_gradients(coords, cells, 2)
    return -2.0 * g[:, list(_CR_OPP), :], vol


def cr_stokes_system(plex, f=(0.0, -1.0), nu=1.0):
    """Stokes with the inf-sup-stable CR/P0 pair on triangles
    (nonconforming P1 velocity, piecewise-constant pressure — the
    classic Crouzeix-Raviart discretization):

        nu (grad u, grad v) - (p, div v) = (f, v)
        (div u, q)                        = 0

    Because pressures are elementwise constants and CR gradients are
    cellwise constant, the discrete solution is EXACTLY divergence-free
    on every cell. Returns (K MatAIJ, rhs Vec, nvel) with velocity dofs
    (edge-midpoint, component-minor) first; pin one pressure dof to fix
    the constant nullspace before solving."""
    import scipy.sparse as sp
    from ..mat.aij import MatAIJ
    from ..vec.vec import Vec as _Vec
    from .plex import _p1_cell_gradients
    cells = np.asarray(plex.cells, dtype=np.int64)
    coords = np.asarray(plex.coords, dtype=np.float64)
    if cells.shape[1] != 3 or coords.shape[1] != 2:
        from ..sys.error import Error
        raise Error("cr_stokes_system: 2-D triangle meshes only")
    edges, c2e = build_edges(cells)
    ne, ncell = len(edges), len(cells)
    gphi, vol = cr_cell_gradients(coords, cells)    # CR grads (nc, 3, 2)
    # vector Laplacian: Ke[k,l] = nu * vol * gphi_k . gphi_l per component
    Ke = nu * np.einsum("ckd,cld,c->ckl", gphi, gphi, vol)
    nvel = 2 * ne
    rows_l, cols_l, vals_l = [], [], []
    for d in range(2):
        r = (c2e * 2 + d)
        rows_l.append(np.repeat(r, 3, axis=1).reshape(-1))
        cols_l.append(np.tile(r, (1, 3)).reshape(-1))
        vals_l.append(Ke.reshape(-1))
    A = sp.csr_matrix((np.concatenate(vals_l),
                       (np.concatenate(rows_l), np.concatenate(cols_l))),
                      shape=(nvel, nvel))
    # divergence: B[c, dof(k,d)] = vol_c * gphi[c,k,d]
    Brows = np.repeat(np.arange(ncell), 6)
    Bcols = np.stack([c2e * 2, c2e * 2 + 1], axis=2).reshape(ncell, -1)
    Bvals = (vol[:, None, None] * gphi).reshape(ncell, -1)
    B = sp.csr_matrix((Bvals.reshape(-1), (Brows, Bcols.reshape(-1))),
                      shape=(ncell, nvel))
    K = sp.bmat([[A, -B.T], [B, None]], format="csr")
    rhs = np.zeros(nvel + ncell)
    # midpoint-rule load: each edge midpoint collects vol/3 per adj cell
    for d in range(2):
        np.add.at(rhs, (c2e * 2 + d).reshape(-1),
                  np.repeat(float(f[d]) * vol / 3.0, 3))
    return (MatAIJ.from_scipy(K, comm=plex.comm),
            _Vec.from_array(rhs, comm=plex.comm), nvel)
