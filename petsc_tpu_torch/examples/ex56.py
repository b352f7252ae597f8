"""3-D Q1 (trilinear hexahedra) displacement-form linear elasticity, block size 3.

The port's copy of ``examples/ex56.py``, the analog of PETSc's
src/ksp/ksp/tutorials/ex56.c: E = 1, nu = 0.25, the unit cube in ne^3
elements, a soft inclusion (alpha) inside radius 0.25, the bottom face held
by the scaled-diagonal BC element, a load of (1, 2, 0) h^2 per node, and
the six rigid-body modes as GAMG's near-nullspace. The element stiffness
comes from 2 x 2 x 2 Gauss quadrature (exact for Q1).

    python -m petsc_tpu_torch.examples.ex56 -ne 11 -ksp_type cg -pc_type gamg

``assemble`` sums the element matrices as 3 x 3 node blocks (16.8 M
blocks at ne 64 where the reference forms 151 M scalar triplets): the same
pattern, values summed over the elements in element order, the same
right-hand side and coordinates. ``main`` passes the rigid-body modes as
``MatNullSpace.createRigidBody(coords)`` (rotations about x, y, z) where
the reference passes ``rigid_body_modes(coords)`` (about z, x, y): the
same space in another column order.
"""

from __future__ import annotations

import sys

import numpy as np

import petsc_tpu_torch as pt


def q1_hex_stiffness(E=1.0, nu=0.25):
    """The 24 x 24 Q1 hexahedral element stiffness on the unit cube, dofs
    (node0_x, node0_y, node0_z, node1_x, ...), nodes in ex56's order
    (0,0,0), (1,0,0), (1,1,0), (0,1,0), (0,0,1), (1,0,1), (1,1,1), (0,1,1)."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2 * mu
    C[3:, 3:] = np.eye(3) * mu
    nodes = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float64)
    g = 0.5 + np.array([-1, 1]) / (2 * np.sqrt(3.0))   # 2-point Gauss on [0, 1]
    K = np.zeros((24, 24))
    for gx in g:
        for gy in g:
            for gz in g:
                dN = np.zeros((8, 3))
                for a in range(8):
                    xa, ya, za = nodes[a]
                    sx = xa * gx + (1 - xa) * (1 - gx)
                    sy = ya * gy + (1 - ya) * (1 - gy)
                    sz = za * gz + (1 - za) * (1 - gz)
                    dN[a] = [(2 * xa - 1) * sy * sz, sx * (2 * ya - 1) * sz,
                             sx * sy * (2 * za - 1)]
                B = np.zeros((6, 24))
                for a in range(8):
                    bx, by, bz = dN[a]
                    B[0, 3 * a] = bx
                    B[1, 3 * a + 1] = by
                    B[2, 3 * a + 2] = bz
                    B[3, 3 * a] = by
                    B[3, 3 * a + 1] = bx
                    B[4, 3 * a + 1] = bz
                    B[4, 3 * a + 2] = by
                    B[5, 3 * a] = bz
                    B[5, 3 * a + 2] = bx
                K += 0.125 * B.T @ C @ B      # weight (1/2)^3 per point
    return K


def rigid_body_modes(coords):
    """The 6 rigid-body modes over (n, 3) coordinates in the reference
    program's column order: three translations, then the rotations about
    z, x and y."""
    n = coords.shape[0]
    B = np.zeros((3 * n, 6))
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    B[0::3, 0] = 1.0
    B[1::3, 1] = 1.0
    B[2::3, 2] = 1.0
    B[0::3, 3], B[1::3, 3] = -y, x          # about z
    B[1::3, 4], B[2::3, 4] = -z, y          # about x
    B[0::3, 5], B[2::3, 5] = z, -x          # about y
    return B


def assemble(ne, soft_alpha=1e-3):
    """(A as a scipy CSR, b, node coordinates) for ne^3 elements."""
    import scipy.sparse as sp
    NN = ne + 1
    h = 1.0 / ne
    nnode = NN ** 3
    K1 = q1_hex_stiffness() * h            # the stiffness scales like h in 3-D
    # the BC element (ex56.c DD2): bottom-face dofs (local < 12) decoupled
    # with a 0.1-scaled diagonal
    K2 = np.where(np.eye(24, dtype=bool), 0.1 * K1, 0.0)
    K2[12:, 12:] = K1[12:, 12:]
    ii, jj, kk = np.meshgrid(np.arange(ne), np.arange(ne), np.arange(ne), indexing="ij")
    base = (ii + NN * jj + NN * NN * kk).reshape(-1)
    off = np.array([0, 1, NN + 1, NN, NN * NN, NN * NN + 1, NN * NN + NN + 1, NN * NN + NN])
    conn = base[:, None] + off[None, :]              # (nel, 8)
    cx = (ii.reshape(-1) + 0.5) * h - 0.5
    cy = (jj.reshape(-1) + 0.5) * h - 0.5
    cz = (kk.reshape(-1) + 0.5) * h - 0.5
    alpha = np.where(np.sqrt(cx * cx + cy * cy + cz * cz) < 0.25, soft_alpha, 1.0)
    is_bc = kk.reshape(-1) == 0
    nel = len(base)
    # element blocks by node pair: (nel, 8, 3, 8, 3) -> (nel * 64, 3, 3)
    blocks = np.empty((nel, 8, 8, 3, 3))
    for K, sel in ((K1, ~is_bc), (K2, is_bc)):
        Kb = K.reshape(8, 3, 8, 3).transpose(0, 2, 1, 3)
        blocks[sel] = Kb[None] * alpha[sel, None, None, None, None]
    key = (conn[:, :, None] * nnode + conn[:, None, :]).reshape(-1)
    order = np.argsort(key, kind="stable")           # element order within a pair
    skey = key[order]
    first = np.flatnonzero(np.concatenate([[True], skey[1:] != skey[:-1]]))
    S = np.add.reduceat(blocks.reshape(-1, 3, 3)[order], first, axis=0)
    del blocks, order
    ukey = skey[first]
    del skey
    brow, bcol = ukey // nnode, ukey % nnode
    cnt = np.bincount(brow, minlength=nnode)
    bptr = np.concatenate([[0], np.cumsum(cnt)])
    indptr = np.concatenate([[0], np.cumsum(np.repeat(3 * cnt, 3))])
    # entry (block, r, c) -> its slot in row 3 brow + r, at 3 (its place in the
    # block row) + c
    nb = len(ukey)
    blk = np.arange(nb)
    pos = (indptr[3 * brow][:, None, None] + np.arange(3)[None, :, None] * (3 * cnt[brow])[:, None, None]
           + 3 * (blk - bptr[brow])[:, None, None] + np.arange(3)[None, None, :])
    data = np.empty(9 * nb)
    indices = np.empty(9 * nb, dtype=np.int64)
    data[pos.reshape(-1)] = S.reshape(-1)
    indices[pos.reshape(-1)] = np.broadcast_to(3 * bcol[:, None, None] + np.arange(3)[None, None, :],
                                               (nb, 3, 3)).reshape(-1)
    A = sp.csr_matrix((data, indices, indptr), shape=(3 * nnode, 3 * nnode))
    # the load: (h^2, 2 h^2, 0) per node of each element; BC elements load
    # only their top nodes (ex56.c vv / v2)
    dofs = (conn[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(-1, 24)
    b = np.zeros(3 * nnode)
    ld = np.zeros((nel, 24))
    ld[:, 0::3] = h * h
    ld[:, 1::3] = 2 * h * h
    ld[is_bc, :12] = 0.0
    np.add.at(b, dofs.reshape(-1), ld.reshape(-1))
    gi, gj, gk = np.meshgrid(np.arange(NN), np.arange(NN), np.arange(NN), indexing="ij")
    coords = np.stack([gi, gj, gk], axis=-1).reshape(-1, 3) * h
    ids = (gi + NN * gj + NN * NN * gk).reshape(-1)
    cc = np.zeros_like(coords)
    cc[ids] = coords
    return A, b, cc


def main(argv=None, device=None):
    """Assemble, solve with the options of `argv` (default: the command
    line; -ne 4, -alpha 1e-3, -ksp_rtol 1e-4, the unpreconditioned norm,
    max_it 200), print the true relative residual and return the KSP. The
    card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    opts = pt.options()
    ne = opts.get_int("ne", default=4)
    A_sp, b_np, coords = assemble(ne, opts.get_real("alpha", default=1e-3))
    A = pt.MatAIJ.from_scipy(A_sp)
    A.setBlockSize(3)
    A.setNearNullSpace(pt.MatNullSpace.createRigidBody(coords))
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setNormType("unpreconditioned")
    ksp.setTolerances(rtol=opts.get_real("ksp_rtol", default=1e-4), max_it=200)
    ksp.setFromOptions()
    b = pt.Vec.from_array(b_np)
    x = A.createVecRight()
    ksp.solve(b, x)
    r = A.createVecLeft()
    A.mult(x, r)
    r.axpy(-1.0, b)
    print(f"|b-Ax|/|b|={float(r.norm()) / float(b.norm()):e}, |b|={float(b.norm()):e}")
    return ksp


if __name__ == "__main__":
    main()
