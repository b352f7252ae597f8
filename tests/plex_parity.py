"""Helpers of the DMPlex/FE/FV parity tests (tests/test_torch_plex*.py,
test_torch_fe*.py, test_torch_multids.py, test_torch_fv.py,
test_torch_examples_plex.py): the same seeded inputs go through the JAX
package and through the port on the CPU, with the card phase's
tolerances (chip_smoke.py's phase plex):

- mesh numbering (cells, coordinates, dof layouts, interpolations, face
  tables) equal;
- assembled values (residuals, Jacobians, right-hand sides) to ASM_RTOL
  relative of their largest entry (the two packages contract in another
  order);
- iterations and reasons equal, histories as tests/nonlinear_parity.py
  holds them (1e-6 relative; entries below 1e-6 of the first to 1e-12 of
  the first), solutions to U_RTOL relative, FV states to FV_TOL of
  max|u|.
"""

import jax.numpy as jnp
import numpy as np
import scipy.sparse.linalg as spla
import torch

import petsc_tpu as pj
import petsc_tpu.dm.fe as R
import petsc_tpu_torch as pt
import petsc_tpu_torch.dm.fe as T
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex
from tests.nonlinear_parity import assert_history, host  # noqa: F401

ASM_RTOL = 1e-12
U_RTOL = 1e-8
FV_TOL = 1e-10


def init(args=()):
    """Both packages' options from the same arguments; the port on the CPU."""
    pj.init(args=list(args))
    pt.init(args=list(args), device="cpu")


def dense(A):
    """A scipy matrix, a MatAIJ of either package, or an array as float64."""
    if hasattr(A, "to_scipy"):
        A = A.to_scipy()
    if hasattr(A, "toarray"):
        return A.toarray()
    return host(A)


def assert_close(got, ref, rtol=ASM_RTOL, what="values"):
    got, ref = dense(got), dense(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (what, err / scale)


def assert_same_pattern(got, ref):
    """Two sparse matrices with the same stored (row, col) pairs."""
    g, r = got.tocsr(), ref.tocsr()
    g.sort_indices()
    r.sort_indices()
    assert np.array_equal(g.indptr, r.indptr) and np.array_equal(g.indices, r.indices)


def assert_same_mesh(p, r):
    assert p.dim == r.dim
    assert np.array_equal(p.cells, np.asarray(r.cells))
    assert np.array_equal(p.coords, np.asarray(r.coords))


def tensor(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# ---- the FE tests' pair of DSs (tests/test_torch_fe*.py) ----

BOX = lambda x: x.min() < 1e-9 or x.max() > 1 - 1e-9     # noqa: E731


def eye(m, n):
    return torch.eye(n, dtype=torch.float64) if m is torch else jnp.eye(n)


def fe_pair(faces, fe_args, forms=None, simplex=True, fe_kw=None, mesh=None, make_fe=None,
            seed=0, check=True, ref=True):
    """(port DS, reference DS) on the same mesh and element; the layout
    equal, and with forms(m) -> (f0, f1) the residual and Jacobian at a
    seeded u to 1e-12. ref=False: the port's DS alone (the finer mesh of a
    convergence study, whose coarser mesh was held to the reference)."""
    init()
    fe_kw = fe_kw or {}
    P = DMPlex.createBoxMesh if mesh is None else None
    p = mesh(DMPlex) if mesh is not None else P(faces, simplex=simplex)
    fe_t = make_fe(T) if make_fe is not None else T.lagrange_fe(*fe_args, **fe_kw)
    if not ref:
        ds = T.DS(p, fe_t)
        if forms is not None:
            ds.setResidual(*forms(torch))
        return ds, None
    r = mesh(RPlex) if mesh is not None else RPlex.createBoxMesh(faces, simplex=simplex)
    fe_r = make_fe(R) if make_fe is not None else R.lagrange_fe(*fe_args, **fe_kw)
    ds, dr = T.DS(p, fe_t), R.DS(r, fe_r)
    assert ds.ndof == dr.ndof
    assert np.array_equal(ds.conn, dr.conn) and np.array_equal(ds.node_conn, dr.node_conn)
    assert np.array_equal(ds.dof_coords, dr.dof_coords)
    if forms is not None:
        ds.setResidual(*forms(torch))
        dr.setResidual(*forms(jnp))
        if check:
            u = np.random.default_rng(seed).standard_normal(ds.ndof)
            assert_close(ds.assembleResidual(u), np.asarray(dr.assembleResidual(u)),
                         what="residual")
            assert_close(ds.assembleJacobian(u), dr.assembleJacobian(u), what="Jacobian")
    return ds, dr


def dirichlet_solve(ds, bnd, ue_bnd=None):
    u0 = np.zeros(ds.ndof)
    J = ds.assembleJacobian(u0)
    F = host(ds.assembleResidual(u0))
    keep = np.ones(ds.ndof, bool)
    keep[bnd] = False
    u = np.zeros(ds.ndof)
    rhs = -F[keep]
    if ue_bnd is not None:
        u[bnd] = ue_bnd
        rhs = rhs - J[keep][:, bnd] @ ue_bnd
    u[keep] = spla.spsolve(J[keep][:, keep].tocsc(), rhs)
    return u


