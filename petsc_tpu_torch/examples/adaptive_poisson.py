"""Adaptive mesh refinement loop on the L-shaped corner singularity
(the classic AMR acceptance problem; reference counterpart:
src/snes/tutorials/ex12.c run with -dm_adapt and the plexadapt.c
machinery).

    -lap u = 0 on the L-shape (-1,1)^2 \\ [0,1)x(-1,0),
    u = r^(2/3) sin(2 theta / 3) on the boundary (the exact solution).

u has a r^(2/3) corner singularity at the origin: uniform P1 meshes
converge at the singularity-limited O(h^(4/3)) in L2 (~N^(-2/3) per
dof; measured h-rate 1.36), while the adaptive loop recovers the
optimal O(h^2) rate (~N^(-1); measured 2.08) — better error with 3x
fewer dofs by 4k dofs.  The loop is the standard estimate ->
Doerfler-mark -> DMAdaptLabel -> solve cycle with the residual-based
gradient-jump indicator

    eta_T^2 = sum_{edges e of T} h_e * [du/dn]_e^2 * |e| / 2.

The port's copy of ``examples/adaptive_poisson.py``: the stiffness matrix
is the DS's element Jacobians on the device (K8, the batched element
kernel), the direct solve is scipy's on the host as in the reference, and
the indicator is vectorised over the cells with the reference's sums.
The sharded solve (-adapt_nshards > 1) comes with ROADMAP queue 1 item 12.

Run: python -m petsc_tpu_torch.examples.adaptive_poisson [-rounds 10] [-theta 0.5]
"""

import json
import sys

import numpy as np

import petsc_tpu_torch as pt
from petsc_tpu_torch.dm.plex import DMPlex


def lshape_mesh(n=4):
    """Triangulated L-shape (-1,1)^2 minus the quadrant x>0, y<0."""
    p = DMPlex.createBoxMesh((2 * n, 2 * n), simplex=True)
    coords = 2.0 * p.coords - 1.0
    cc = coords[p.cells].mean(axis=1)
    keep = ~((cc[:, 0] > 0) & (cc[:, 1] < 0))
    q = DMPlex.createFromCellList(2, p.cells[keep], coords)
    # drop unused vertices for a clean chart
    used = np.unique(q.cells)
    remap = -np.ones(len(coords), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return DMPlex.createFromCellList(2, remap[q.cells], coords[used])


def exact(xy):
    x, y = xy[..., 0], xy[..., 1]
    r = np.hypot(x, y)
    th = np.arctan2(y, x)
    th = np.where(th < 0, th + 2 * np.pi, th)   # L-shape opens at 3pi/2
    return np.where(r > 0, r ** (2.0 / 3.0) * np.sin(2 * th / 3), 0.0)


def solve_p1(plex):
    """P1 Poisson with exact-solution Dirichlet data; returns (u, ndof,
    L2 error, cell gradients, volumes)."""
    import scipy.sparse.linalg as spla
    from petsc_tpu_torch.dm.fe import DS, lagrange_fe
    ds = DS(plex, lagrange_fe(2, 1))
    ds.setResidual(f1=lambda u_, gu_, x: gu_)
    S = ds.assembleJacobian(np.zeros(ds.ndof)).tocsr()
    bnd = plex.markBoundaryVertices()
    keep = np.ones(plex.nvertices, bool)
    keep[bnd] = False
    ub = np.zeros(plex.nvertices)
    ub[bnd] = exact(plex.coords)[bnd]
    rhs = -(S @ ub)
    u = ub.copy()
    u[keep] = spla.spsolve(S[keep][:, keep].tocsc(), rhs[keep])
    # L2 error by degree-2 cell quadrature (the exact SOLUTION is
    # bounded — r^(2/3) — so the quadrature is rate-faithful; the exact
    # GRADIENT is r^(-1/3)-singular and pointwise quadrature of the H1
    # error near the corner would diverge)
    from petsc_tpu_torch.dm.fe import stroud_conical_quadrature
    from petsc_tpu_torch.dm.plex import _p1_cell_gradients
    gph, vol = _p1_cell_gradients(plex.coords, plex.cells, 2)
    gu = np.einsum("cvd,cv->cd", np.asarray(gph), u[plex.cells])
    vol = np.asarray(vol)
    qp, qw = stroud_conical_quadrature(2, 2)
    lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
    xq = np.einsum("qv,cvd->cqd", lam, plex.coords[plex.cells])
    uq = np.einsum("qv,cv->cq", lam, u[plex.cells])
    err = np.sqrt((2 * vol[:, None] * qw[None, :]
                   * (uq - exact(xq)) ** 2).sum())
    return u, plex.nvertices, err, gu, vol


def estimate(plex, gu):
    """Gradient-jump indicator per cell (the residual estimator's edge
    term; f = 0 so the volume term vanishes)."""
    from petsc_tpu_torch.dm.fe import build_edges
    edges, c2e = build_edges(plex.cells)
    ne = len(edges)
    elen = np.linalg.norm(plex.coords[edges[:, 1]]
                          - plex.coords[edges[:, 0]], axis=1)
    tang = (plex.coords[edges[:, 1]] - plex.coords[edges[:, 0]]) \
        / elen[:, None]
    nrml = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
    # per-edge one-sided normal derivatives (same fixed edge normal for
    # both sides, so the jump is their difference), the first and the
    # second in cell order
    val = (gu[:, None, :] * nrml[c2e]).sum(axis=2).reshape(-1)
    e = c2e.reshape(-1)
    order = np.argsort(e, kind="stable")
    cnt = np.bincount(e, minlength=ne)
    start = np.concatenate([[0], np.cumsum(cnt)])
    jump2 = np.zeros(ne)
    two = np.flatnonzero(cnt == 2)
    jump2[two] = (val[order[start[two]]] - val[order[start[two] + 1]]) ** 2
    eta_e = elen * jump2 * elen / 2        # h_e * [du/dn]^2 * |e| / 2
    return eta_e[c2e].sum(axis=1)


def doerfler_mark(eta, theta=0.5):
    order = np.argsort(eta)[::-1]
    csum = np.cumsum(eta[order])
    k = int(np.searchsorted(csum, theta * csum[-1])) + 1
    return order[:k]


def solve_p1_sharded(plex, nshards):
    """The sharded round body (redistribute, assemble per shard, CG +
    Jacobi over the mesh): ROADMAP queue 1 item 12."""
    raise pt.Error("adaptive_poisson -adapt_nshards > 1: the sharded solve comes with "
                   "ROADMAP queue 1 item 12 (distribution over several cards)")


def main(argv=None, device=None):
    """The adaptive and the uniform loops; the card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    opts = pt.options()
    rounds = opts.get_int("rounds", default=8)
    theta = opts.get_real("theta", default=0.5)
    nshards = opts.get_int("adapt_nshards", default=1)

    # adaptive loop (with -adapt_nshards S: per-round redistribution of
    # the adapted mesh and a sharded MPIAIJ solve)
    plex = lshape_mesh(4)
    adapt_hist = []
    for it in range(rounds):
        if nshards > 1:
            u, ndof, err, gu, vol = solve_p1_sharded(plex, nshards)
        else:
            u, ndof, err, gu, vol = solve_p1(plex)
        adapt_hist.append((ndof, err))
        print(f"[adapt {it}] dofs={ndof:6d}  |u-uh|_L2={err:.4e}",
              flush=True)
        if it < rounds - 1:
            marked = doerfler_mark(estimate(plex, gu), theta)
            plex = plex.adaptLabel(marked)

    # uniform yardstick
    uni_hist = []
    plex = lshape_mesh(4)
    for it in range(min(rounds, 5)):
        u, ndof, err, gu, vol = solve_p1(plex)
        uni_hist.append((ndof, err))
        print(f"[unif  {it}] dofs={ndof:6d}  |u-uh|_L2={err:.4e}",
              flush=True)
        if it < min(rounds, 5) - 1:
            plex = plex.refine()

    # rates vs dofs: err ~ N^-r
    def rate(h):
        (n1, e1), (n2, e2) = h[0], h[-1]
        return np.log(e1 / e2) / np.log(np.sqrt(n2 / n1))
    out = {"adaptive": adapt_hist, "uniform": uni_hist,
           "adaptive_rate_h": round(float(rate(adapt_hist)), 3),
           "uniform_rate_h": round(float(rate(uni_hist)), 3)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
