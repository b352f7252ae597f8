"""The port's MultiDS (petsc_tpu_torch/dm/multids.py) against the JAX
package's on the CPU: tests/test_multids.py's CR/P0 Stokes against the
bespoke cr_stokes_system, its fieldsplit Schur solve, the Taylor-Hood and
FOSLS patches and the Navier-Stokes Newton solve, each with the coupled
residual and Jacobian at seeded inputs to 1e-12 of the reference's. The
quadrature degree is passed explicitly (the reference's default
under-integrates nonlinear residuals: ROADMAP section 3).

Pointwise functions are written once against an array module m
(jax.numpy or torch), out of place."""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
import jax.numpy as jnp

import petsc_tpu.dm.fe as R
import petsc_tpu.dm.multids as RM
import petsc_tpu_torch as pt
import petsc_tpu_torch.dm.fe as T
import petsc_tpu_torch.dm.multids as TM
from petsc_tpu.dm.plex import DMPlex as RPlex
from petsc_tpu_torch.dm.plex import DMPlex
from tests.plex_parity import assert_close, eye, host, init

torch.set_num_threads(1)


def _vec(m, vals):
    return torch.tensor(vals, dtype=torch.float64) if m is torch else jnp.array(vals)


def _pair(faces, fields, forms, qdeg, seed=0):
    """(port MultiDS, reference MultiDS) with forms(m, mod) -> {name: (f0, f1)}
    and the coupled residual and Jacobian at a seeded u to 1e-12."""
    init()
    out = []
    for m, mod, mds, P in ((torch, T, TM, DMPlex), (jnp, R, RM, RPlex)):
        ds = mds.MultiDS(P.createBoxMesh(faces, simplex=True), fields(mod), qdeg=qdeg)
        for name, (f0, f1) in forms(m).items():
            ds.setResidual(name, f0=f0, f1=f1)
        out.append(ds)
    ds, dr = out
    assert ds.ndof == dr.ndof and np.array_equal(ds.conn, dr.conn)
    assert np.array_equal(ds.offsets, dr.offsets)
    u = np.random.default_rng(seed).standard_normal(ds.ndof)
    assert_close(ds.assembleResidual(u), np.asarray(dr.assembleResidual(u)))
    assert_close(ds.assembleJacobian(u), dr.assembleJacobian(u))
    return ds, dr


def _cr_p0_fields(mod):
    vfe = mod.crouzeix_raviart_fe()
    vfe.ncomp = 2
    return [("u", vfe), ("p", mod.p0disc_fe(2))]


def _stokes_forms(f, nu):
    def forms(m):
        fv = _vec(m, list(f))
        return {"u": (lambda u, gu, x: -fv, lambda u, gu, x: nu * gu[0] - u[1] * eye(m, 2)),
                "p": (lambda u, gu, x: gu[0][0, 0] + gu[0][1, 1], None)}
    return forms


def _pin(Ks, b, pinned, vals=None):
    Ks = Ks.tolil()
    for i, r in enumerate(pinned):
        Ks.rows[r] = [int(r)]
        Ks.data[r] = [1.0]
        b[r] = 0.0 if vals is None else vals[i]
    Ks = Ks.tocsr().tocoo()
    keep = ~np.isin(Ks.col, pinned) | (Ks.row == Ks.col)
    if vals is not None:
        drop = ~keep
        np.subtract.at(b, Ks.row[drop], Ks.data[drop]
                       * np.asarray(vals)[np.searchsorted(pinned, Ks.col[drop])])
    return sp.csr_matrix((Ks.data[keep], (Ks.row[keep], Ks.col[keep])), shape=Ks.shape), b


def test_multids_matches_bespoke_stokes():
    """The generic coupled Jacobian equals cr_stokes_system's assembly (the
    port's and the reference's) to machine precision."""
    nu = 1.3
    ds, _ = _pair((6, 6), _cr_p0_fields, _stokes_forms((0.7, -1.1), nu), qdeg=2)
    K, rhs, nvel = T.cr_stokes_system(DMPlex.createBoxMesh((6, 6)), f=(0.7, -1.1), nu=nu)
    Kr, rhsr, _ = R.cr_stokes_system(RPlex.createBoxMesh((6, 6)), f=(0.7, -1.1), nu=nu)
    assert_close(K, Kr)
    assert_close(rhs, np.asarray(rhsr.getArray())[: ds.ndof])
    assert ds.offsets[1] == nvel
    d = ds.assembleJacobian(np.zeros(ds.ndof)) - K.to_scipy()
    assert (abs(d).max() if d.nnz else 0.0) < 1e-13
    F = host(ds.assembleResidual(np.zeros(ds.ndof)))
    assert np.abs(-F - host(rhs)[: ds.ndof]).max() < 1e-14


def test_multids_stokes_fieldsplit_solve():
    """The generic Stokes system pinned and solved by FGMRES + PCFieldSplit
    Schur (selfp) on the port: the direct solve's answer."""
    ds, _ = _pair((6, 6), _cr_p0_fields, _stokes_forms((0.0, -1.0), 1.0), qdeg=2)
    plex = DMPlex.createBoxMesh((6, 6))
    J = ds.assembleJacobian(np.zeros(ds.ndof))
    b = -host(ds.assembleResidual(np.zeros(ds.ndof)))
    edges, _ = T.build_edges(plex.cells)
    mid = 0.5 * (plex.coords[edges[:, 0]] + plex.coords[edges[:, 1]])
    bnd_e = np.nonzero((mid.min(axis=1) < 1e-9) | (mid.max(axis=1) > 1 - 1e-9))[0]
    nvel = ds.offsets[1]
    pinned = np.sort(np.concatenate([bnd_e * 2, bnd_e * 2 + 1, [nvel]]))
    Ks, b = _pin(J, b, pinned)
    ref = spla.spsolve(Ks.tocsc(), b)
    M = pt.MatAIJ.from_scipy(Ks)
    ksp = pt.KSP().create()
    ksp.setType("fgmres")
    ksp.setOperators(M)
    pc = ksp.getPC()
    pc.setType("fieldsplit")
    pc.setFieldSplitType("schur")
    pc.setFieldSplitSchurPreType("selfp")
    pc.setFieldSplitIS(("u", ds.field_indices("u")), ("p", ds.field_indices("p")))
    ksp.setTolerances(rtol=1e-12, max_it=400)
    x = M.createVecRight()
    ksp.solve(pt.Vec.from_array(b), x)
    assert ksp.getConvergedReason().converged
    assert np.abs(host(x)[: ds.ndof] - ref).max() < 1e-7 * max(1.0, np.abs(ref).max())


def _th_fields(mod):
    return [("u", mod.lagrange_fe(2, 2, ncomp=2)), ("p", mod.lagrange_fe(2, 1))]


def test_multids_taylor_hood_patch():
    nu = 0.8
    ds, _ = _pair((4, 4), _th_fields, lambda m: {
        "u": (None, lambda u, gu, x: nu * gu[0] - u[1] * eye(m, 2)),
        "p": (lambda u, gu, x: gu[0][0, 0] + gu[0][1, 1], None)}, qdeg=4)
    J = ds.assembleJacobian(np.zeros(ds.ndof))
    b = -host(ds.assembleResidual(np.zeros(ds.ndof)))
    Xu, Xp = ds.subs[0].dof_coords, ds.subs[1].dof_coords
    uex = np.stack([Xu[:, 1] ** 2, Xu[:, 0] ** 2], axis=1).reshape(-1)
    pex = 2 * nu * (Xp[:, 0] + Xp[:, 1])
    onb = (Xu.min(axis=1) < 1e-9) | (Xu.max(axis=1) > 1 - 1e-9)
    bdofs = (np.nonzero(onb)[0][:, None] * 2 + np.arange(2)).reshape(-1)
    allp = np.concatenate([bdofs, [ds.offsets[1]]])
    pinned = np.sort(allp)
    vals = np.concatenate([uex[bdofs], [pex[0]]])[np.argsort(allp)]
    Ks, b = _pin(J, b, pinned, vals)
    s = spla.spsolve(Ks.tocsc(), b)
    assert np.abs(s[: ds.offsets[1]] - uex).max() < 1e-10
    assert np.abs(s[ds.offsets[1]:] - pex).max() < 1e-9


def test_multids_fosls_mixed_poisson_patch():
    ds, _ = _pair((5, 5), lambda mod: [("u", mod.lagrange_fe(2, 1, ncomp=2)),
                                       ("p", mod.lagrange_fe(2, 1))], lambda m: {
        "u": (lambda u, gu, x: u[0] + gu[1],
              lambda u, gu, x: (gu[0][0, 0] + gu[0][1, 1]) * eye(m, 2)),
        "p": (None, lambda u, gu, x: u[0] + gu[1])}, qdeg=2)
    J = ds.assembleJacobian(np.zeros(ds.ndof))
    b = -host(ds.assembleResidual(np.zeros(ds.ndof)))
    Xu, Xp = ds.subs[0].dof_coords, ds.subs[1].dof_coords
    uex = np.broadcast_to(np.array([-2.0, -3.0]), (len(Xu), 2)).reshape(-1).copy()
    pex = 2 * Xp[:, 0] + 3 * Xp[:, 1]
    onb_u = (Xu.min(axis=1) < 1e-9) | (Xu.max(axis=1) > 1 - 1e-9)
    onb_p = (Xp.min(axis=1) < 1e-9) | (Xp.max(axis=1) > 1 - 1e-9)
    bu = (np.nonzero(onb_u)[0][:, None] * 2 + np.arange(2)).reshape(-1)
    bp = np.nonzero(onb_p)[0] + ds.offsets[1]
    pinned = np.concatenate([bu, bp])
    vals = np.concatenate([uex[bu], pex[np.nonzero(onb_p)[0]]])
    order = np.argsort(pinned)
    Ks, b = _pin(J, b, pinned[order], vals[order])
    s = spla.spsolve(Ks.tocsc(), b)
    assert np.abs(s[: ds.offsets[1]] - uex).max() < 1e-9
    assert np.abs(s[ds.offsets[1]:] - pex).max() < 1e-9


def test_multids_navier_stokes_newton():
    """Steady Navier-Stokes (Taylor-Hood, convection in f0_u, qdeg 6):
    Newton with the port's coupled Jacobian reaches the manufactured
    solution quadratically, its residual norms the reference's at each
    step (1e-6 relative, or 1e-12 of the first below 1e-6 of it)."""
    nu = 0.7

    def forms(m):
        def f0_u(u, gu, x):
            return gu[0] @ u[0] - m.stack([2 * x[0] ** 2 * x[1], 2 * x[0] * x[1] ** 2])
        return {"u": (f0_u, lambda u, gu, x: nu * gu[0] - u[1] * eye(m, 2)),
                "p": (lambda u, gu, x: gu[0][0, 0] + gu[0][1, 1], None)}

    ds, dr = _pair((4, 4), _th_fields, forms, qdeg=6)
    Xu, Xp = ds.subs[0].dof_coords, ds.subs[1].dof_coords
    uex = np.stack([Xu[:, 1] ** 2, Xu[:, 0] ** 2], axis=1).reshape(-1)
    pex = 2 * nu * (Xp[:, 0] + Xp[:, 1])
    onb = (Xu.min(axis=1) < 1e-9) | (Xu.max(axis=1) > 1 - 1e-9)
    bdofs = (np.nonzero(onb)[0][:, None] * 2 + np.arange(2)).reshape(-1)
    pinned = np.sort(np.concatenate([bdofs, [ds.offsets[1]]]))
    vals_map = dict(zip(bdofs, uex[bdofs]))
    vals_map[int(ds.offsets[1])] = pex[0]
    runs = []
    for d, assemble in ((ds, lambda d, u: host(d.assembleResidual(u))),
                        (dr, lambda d, u: np.asarray(d.assembleResidual(u)).copy())):
        u = np.zeros(ds.ndof)
        u[pinned] = [vals_map[int(i)] for i in pinned]
        norms = []
        for _ in range(8):
            F = assemble(d, u)
            F[pinned] = 0.0
            norms.append(np.linalg.norm(F))
            if norms[-1] < 1e-12:
                break
            J = d.assembleJacobian(u).tolil()
            for r in pinned:
                J.rows[r] = [int(r)]
                J.data[r] = [1.0]
            u = u + spla.spsolve(J.tocsr().tocsc(), -F)
        runs.append((norms, u))
    (norms, u), (norms_r, _) = runs
    assert len(norms) == len(norms_r) and norms[-1] < 1e-12 and norms[-2] > 10 * norms[-1]
    for g, w in zip(norms, norms_r):
        assert abs(g - w) <= (1e-6 * w if w >= 1e-6 * norms_r[0] else 1e-12 * norms_r[0])
    assert np.abs(u[: ds.offsets[1]] - uex).max() < 1e-8
    assert np.abs(u[ds.offsets[1]:] - pex).max() < 1e-7


def test_multids_retabulation_and_field_indices():
    init()
    p, r = DMPlex.createBoxMesh((3, 3)), RPlex.createBoxMesh((3, 3))
    for fields in (_th_fields, _cr_p0_fields):
        a = TM.MultiDS(p, fields(T), qdeg=4)
        b = RM.MultiDS(r, fields(R), qdeg=4)
        for (B, D), (Br, Dr) in zip(a.tabs, b.tabs):
            assert np.allclose(B, Br, rtol=0, atol=1e-14) and np.allclose(D, Dr, rtol=0, atol=1e-13)
        assert np.array_equal(a.field_indices("p"), b.field_indices("p"))
