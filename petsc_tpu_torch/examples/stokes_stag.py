"""2-D Stokes flow on a staggered (MAC) grid: DMStag + fieldsplit/Schur.

The port's copy of ``examples/stokes_stag.py`` (the reference's DMStag
Stokes demos, src/dm/impls/stag tutorials): u on vertical faces, v on
horizontal faces, p on elements; -Lap(u) + grad p = f, div u = 0 with
homogeneous velocity walls; FGMRES + PCFieldSplit Schur (full
factorization, selfp), ILU(0) on the velocity block, Jacobi on the
pressure block. The manufactured solution u = curl(psi), psi = (x(1-x)
y(1-y))^2, checks discretization and solver.

The reference assembles in Python loops over faces and elements; here the
same triplets come from numpy arrays, each row's entries in the order the
reference's loops give them, so the CSR after ``sum_duplicates`` is the
reference's bit for bit.

    python -m petsc_tpu_torch.examples.stokes_stag -n 24
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp

import petsc_tpu_torch as pt
from petsc_tpu_torch.dm.stag import DMStag


def psi(x, y):
    return (x * (1 - x) * y * (1 - y)) ** 2


def exact_u(x, y):
    # u = d(psi)/dy
    return 2 * (x * (1 - x)) ** 2 * (y * (1 - y)) * (1 - 2 * y)


def exact_v(x, y):
    # v = -d(psi)/dx
    return -2 * (y * (1 - y)) ** 2 * (x * (1 - x)) * (1 - 2 * x)


def _lap4(fn, x, y, h=1e-4):
    return (fn(x + h, y) + fn(x - h, y) + fn(x, y + h) + fn(x, y - h)
            - 4 * fn(x, y)) / h ** 2


def _momentum(r, wall, along, across, lo_wall, hi_wall, p_hi, p_lo, h):
    """Triplets of the interior momentum rows r (seven a row, in the
    reference's order: the diagonal, the two neighbours along the normal,
    the two across it, a wall's reflected ghost onto the diagonal, then
    the pressure gradient) and of the wall rows (the diagonal 1.0)."""
    c2, c1 = 1.0 / h ** 2, 1.0 / h
    ri = r[~wall]
    cols = np.stack([ri, along[0][~wall], along[1][~wall],
                     np.where(lo_wall[~wall], ri, across[0][~wall]),
                     np.where(hi_wall[~wall], ri, across[1][~wall]),
                     p_hi[~wall], p_lo[~wall]], axis=1)
    vals = np.empty(cols.shape)
    vals[:, 0] = 4.0 / h ** 2
    vals[:, 1:3] = -c2
    vals[:, 3] = np.where(lo_wall[~wall], c2, -c2)
    vals[:, 4] = np.where(hi_wall[~wall], c2, -c2)
    vals[:, 5], vals[:, 6] = c1, -c1
    rw = r[wall]
    rows = np.concatenate([np.repeat(ri, 7), rw])
    return rows, np.concatenate([cols.ravel(), rw]), \
        np.concatenate([vals.ravel(), np.ones(len(rw))])


def assemble(n):
    """MAC discretization on an n x n element grid: (DMStag, scipy CSR,
    b, (off_u, off_v, off_p)). Unknowns in DMStag stratum order: u on the
    left faces (n rows of n + 1), v on the down faces (n + 1 rows of n),
    p on the elements (n x n), the boundary-face velocities pinned and
    p(0, 0) pinned."""
    st = DMStag.create((n, n), (0, 1, 1))
    offs = st.getStratumOffsets()
    off_u, off_v, off_p = offs["left_face"][0], offs["down_face"][0], offs["element"][0]
    h = 1.0 / n
    N = st.N
    b = np.zeros(N)

    def uid(j, i):
        return off_u + j * (n + 1) + i

    def vid(j, i):
        return off_v + j * n + i

    def pid(j, i):
        return off_p + j * n + i

    # u-momentum at the vertical faces: row (j, i), j < n, i <= n
    j, i = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n + 1), indexing="ij"))
    r = uid(j, i)
    wall = (i == 0) | (i == n)
    ru, cu, vu = _momentum(r, wall, (uid(j, i - 1), uid(j, i + 1)),
                           (uid(j - 1, i), uid(j + 1, i)), j == 0, j == n - 1,
                           pid(j, i), pid(j, i - 1), h)
    b[r[~wall]] = -_lap4(exact_u, i[~wall] * h, (j[~wall] + 0.5) * h)
    # v-momentum at the horizontal faces: row (j, i), j <= n, i < n
    j, i = (a.ravel() for a in np.meshgrid(np.arange(n + 1), np.arange(n), indexing="ij"))
    r = vid(j, i)
    wall = (j == 0) | (j == n)
    rv, cv, vv = _momentum(r, wall, (vid(j - 1, i), vid(j + 1, i)),
                           (vid(j, i - 1), vid(j, i + 1)), i == 0, i == n - 1,
                           pid(j, i), pid(j - 1, i), h)
    b[r[~wall]] = -_lap4(exact_v, (i[~wall] + 0.5) * h, j[~wall] * h)
    # continuity at the elements, then the pressure pin at p(0, 0)
    j, i = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n), indexing="ij"))
    rp = np.repeat(pid(j, i), 4)
    cp = np.stack([uid(j, i + 1), uid(j, i), vid(j + 1, i), vid(j, i)], axis=1).ravel()
    vp = np.tile([1.0 / h, -1.0 / h, 1.0 / h, -1.0 / h], n * n)
    r0 = pid(0, 0)
    rows = np.concatenate([ru, rv, rp, [r0]])
    cols = np.concatenate([cu, cv, cp, [r0]])
    vals = np.concatenate([vu, vv, vp, [1.0]])
    A = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    A.sum_duplicates()
    return st, A, b, (off_u, off_v, off_p)


def errors(sol, n, off_u, off_v):
    """(max |u - u_exact| over the interior vertical faces, max |div u|)."""
    h = 1.0 / n
    u = sol[off_u:off_u + n * (n + 1)].reshape(n, n + 1)
    v = sol[off_v:off_v + (n + 1) * n].reshape(n + 1, n)
    j, i = np.meshgrid(np.arange(n), np.arange(1, n), indexing="ij")
    uerr = float(np.abs(u[:, 1:n] - exact_u(i * h, (j + 0.5) * h)).max()) if n > 1 else 0.0
    div = float(np.abs((u[:, 1:] - u[:, :-1] + v[1:, :] - v[:-1, :]) / h).max())
    return uerr, div


def setup(A_sp, b_np, off_p):
    """The reference's solver on the assembled system (velocities before
    off_p, pressures after): (ksp, A, b)."""
    from petsc_tpu_torch.parallel.index import IS
    A = pt.MatAIJ.from_scipy(A_sp)
    ksp = pt.KSP().create()
    ksp.setOperators(A)
    ksp.setType("fgmres")
    pc = ksp.getPC()
    pc.setType("fieldsplit")
    pc._impl.ftype = "schur"
    pc._impl.schur_fact = "full"
    pc._impl.schur_pre = "selfp"
    pc._impl.setIS("v", IS.createStride(off_p))                    # velocities
    pc._impl.setIS("p", IS.createStride(A_sp.shape[0] - off_p, off_p))
    pt.options().set_value("fieldsplit_v_pc_type", "ilu")
    pt.options().set_value("fieldsplit_p_pc_type", "jacobi")
    ksp.setTolerances(rtol=1e-10, max_it=400)
    return ksp, A, pt.Vec.from_array(b_np)


def main(argv=None, device=None):
    """Assemble and solve at -n (16 by default); print and return (ksp,
    u_err, max|div u|). The card unless device="cpu"."""
    pt.init(args=argv if argv is not None else sys.argv[1:], device=device)
    n = pt.options().get_int("n", default=16)
    _, A_sp, b_np, (off_u, off_v, off_p) = assemble(n)
    ksp, A, b = setup(A_sp, b_np, off_p)
    x = A.createVecRight()
    ksp.solve(b, x)
    uerr, div = errors(x.getArray(), n, off_u, off_v)
    print(f"its {ksp.getIterationNumber()} u_err {uerr:.3e} "
          f"max|div u| {div:.3e}")
    return ksp, uerr, div


if __name__ == "__main__":
    main()
