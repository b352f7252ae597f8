"""Generic multi-field discretization system (PetscDS role).

Behavioral reference: src/dm/dt/interface/dtds.c (N fields, per-field
residual pointwise functions f0/f1 that SEE every field's value and
gradient) and src/dm/impls/plex/plexfem.c's multi-field assembly (the
per-field-pair g0..g3 Jacobian blocks). Counterpart of ``petsc_tpu/dm/multids.py``: the
coupled element residual is ONE torch function over the concatenated
element dof vector, batched over the cells, and every Jacobian block — all
field pairs at once — comes from its forward-mode derivative (one
``torch.func.jvp`` per element dof, batched by ``torch.func.vmap``; the
reference's ``vmap(jacfwd)``). No hand-coded g0..g3 kernels: autodiff of
the residual IS the per-pair block structure. The element solution is one
K8 gather, the global residual X1's add mode (as DS's).

Scope: affine simplex cells (the CR/P0 Stokes and Taylor-Hood pairs
this replaces bespoke assemblies for); fields are Lagrange (any order,
any ncomp), Crouzeix-Raviart, or P0disc, retabulated on one shared
quadrature. H(div) dual spaces (RT/BDM/Nedelec) keep their bespoke
constructions (fe.py) — their dofs are signed functionals, not nodal
values, and SURVEY scopes Piola-mapped generic assembly out.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.gather_kernels import gather
from ..ops.pc_kernels import dst_scatter, scatter_table
from ..sys.error import Error
from .fe import (DS, crouzeix_raviart_fe, lagrange_fe, p0disc_fe,  # noqa: F401
                 stroud_conical_quadrature, _as_device, _det_small, _inv_small, host_array)


def _retabulate(fe, qp):
    """(B (nq, nb), D (nq, nb, dim)) of `fe` at the shared quadrature."""
    dim = fe.dim
    if getattr(fe, "order", None) is not None:
        twin = lagrange_fe(dim, fe.order, cell=fe.cell, ncomp=fe.ncomp)
        if twin.nb != fe.nb:
            raise Error("multids: unsupported lagrange variant")
        from .fe import _eval_monomials, _p_monomials
        expo = _p_monomials(dim, fe.order)
        Vn, _ = _eval_monomials(expo, np.asarray(fe.nodes))
        C = np.linalg.inv(Vn)
        Vq, Gq = _eval_monomials(expo, qp)
        return Vq @ C, np.einsum("qmd,mb->qbd", Gq, C)
    if fe.dof_kind == "facet" and dim == 2:            # Crouzeix-Raviart
        x, y = qp[:, 0], qp[:, 1]
        lam = np.stack([1 - x - y, x, y], axis=1)
        gl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        opp = (2, 0, 1)
        B = np.stack([1 - 2 * lam[:, opp[k]] for k in range(3)], axis=1)
        D = np.broadcast_to(
            np.stack([-2 * gl[opp[k]] for k in range(3)]),
            (len(qp), 3, 2)).copy()
        return B, D
    if fe.dof_kind == "cell":                          # P0disc
        return (np.ones((len(qp), 1)),
                np.zeros((len(qp), 1, dim)))
    raise Error(f"multids: cannot retabulate element '{fe.name}'")


class MultiDS:
    """N coupled fields over one simplex plex; per-field weak forms see
    ALL fields. Global dof vector = concatenation of per-field blocks
    (field-major — PCFieldSplit ISes are just the block ranges)."""

    def __init__(self, plex, fields, qdeg=None):
        self.plex = plex
        self.names = [nm for nm, _ in fields]
        self.fes = [fe for _, fe in fields]
        dim = self.fes[0].dim
        if getattr(self.fes[0], "cell", "simplex") != "simplex":
            raise Error("multids: simplex meshes only")
        if qdeg is None:
            qdeg = max(max(2 * (getattr(fe, "order", None) or 1), 2)
                       for fe in self.fes)
        self.qp, self.qw = stroud_conical_quadrature(dim, qdeg)
        self.dim = dim
        # per-field layouts via the single-field DS (conn/ndof/coords)
        self.subs = [DS(plex, fe) for fe in self.fes]
        self.tabs = [_retabulate(fe, self.qp) for fe in self.fes]
        self.offsets = np.concatenate(
            [[0], np.cumsum([s.ndof for s in self.subs])])
        self.ndof = int(self.offsets[-1])
        self.f0 = [None] * len(self.fes)
        self.f1 = [None] * len(self.fes)
        # coupled element connectivity: per cell, global dofs of every
        # field's element dofs, field blocks concatenated
        self.conn = np.concatenate(
            [s.conn + off for s, off in zip(self.subs, self.offsets[:-1])],
            axis=1)
        self._dev = {}

    def field_indices(self, name):
        i = self.names.index(name)
        return np.arange(self.offsets[i], self.offsets[i + 1])

    def setResidual(self, name, f0=None, f1=None):
        """Weak form of field `name`: residual contribution
        ∫ f0·v + f1:∇v with f0(u, gu, x), f1(u, gu, x); u/gu are tuples
        over ALL fields (scalar fields: u[i] scalar, gu[i] (dim,);
        ncomp>1: u[i] (nc,), gu[i] (nc, dim))."""
        i = self.names.index(name)
        self.f0[i] = f0
        self.f1[i] = f1
        self._kern = None
        return self

    _kern = None

    def _tables(self):
        dev, dt = config.device(), config.real_dtype()
        key = (str(dev), dt)
        tab = self._dev.get(key)
        if tab is not None:
            return tab
        dim = self.dim
        qp = np.asarray(self.qp)
        xe = torch.as_tensor(np.asarray(self.plex.coords)[np.asarray(self.plex.cells)],
                             dtype=dt, device=dev)
        J = torch.stack([xe[:, i + 1] - xe[:, 0] for i in range(dim)], dim=2)
        dj = _det_small(J)
        lam = torch.as_tensor(np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1),
                              dtype=dt, device=dev)
        conn = np.asarray(self.conn, dtype=np.int64)
        nc, nb = conn.shape
        tab = {
            "Jinv": _inv_small(J, dj).contiguous(),
            "wdet": (torch.as_tensor(np.asarray(self.qw), dtype=dt, device=dev)
                     * torch.abs(dj)[:, None]).contiguous(),
            "xq": torch.einsum("qv,cvd->cqd", lam, xe[:, : dim + 1]).contiguous(),
            "Bs": [torch.as_tensor(B, dtype=dt, device=dev) for B, _ in self.tabs],
            "Ds": [torch.as_tensor(D, dtype=dt, device=dev) for _, D in self.tabs],
            "conn": torch.as_tensor(conn.reshape(-1).astype(np.int32), device=dev),
            "scatter": scatter_table(conn.reshape(-1), np.arange(nc * nb), self.ndof,
                                     nc * nb, device=dev, dtype=dt),
        }
        self._dev[key] = tab
        return tab

    def _element_kernel(self):
        """The coupled element residual batched over cells: element(ue (nc,
        nE), Jinv (nc, d, d), wdet (nc, nq), xq (nc, nq, d)) -> (nc, nE)."""
        if self._kern is not None:
            return self._kern
        dim = self.dim
        nfe = len(self.fes)
        ncs = [getattr(fe, "ncomp", 1) for fe in self.fes]
        nbs = [fe.nb for fe in self.fes]
        sizes = [nb * nc for nb, nc in zip(nbs, ncs)]
        f0s, f1s = list(self.f0), list(self.f1)

        def pointwise(i):
            nci = ncs[i]

            def shaped(r, x, shape):
                if isinstance(r, torch.Tensor):
                    return r
                return x.new_zeros(shape) + r

            zf0 = () if nci == 1 else (nci,)
            zf1 = (dim,) if nci == 1 else (nci, dim)
            f0, f1 = f0s[i], f1s[i]

            def at_q(u, gu, x):
                a = f0(u, gu, x) if f0 is not None else 0.0
                b = f1(u, gu, x) if f1 is not None else 0.0
                return shaped(a, x, zf0), shaped(b, x, zf1)
            return torch.func.vmap(at_q)

        vfs = [pointwise(i) for i in range(nfe)]

        def element(ue_all, Bs, Ds, Jinv, wdet, xq):
            nc, nq = wdet.shape
            ues = torch.split(ue_all, sizes, dim=1)
            uqs, guqs, gDs = [], [], []
            for i in range(nfe):
                gD = torch.einsum("qbd,cde->cqbe", Ds[i], Jinv)
                gDs.append(gD)
                if ncs[i] == 1:
                    uqs.append(torch.einsum("qb,cb->cq", Bs[i], ues[i]).reshape(-1))
                    guqs.append(torch.einsum("cqbe,cb->cqe", gD, ues[i]).reshape(-1, dim))
                else:
                    un = ues[i].reshape(nc, nbs[i], ncs[i])
                    uqs.append(torch.einsum("qb,cbk->cqk", Bs[i], un).reshape(-1, ncs[i]))
                    guqs.append(torch.einsum("cqbe,cbk->cqke", gD, un)
                                .reshape(-1, ncs[i], dim))
            xf = xq.reshape(nc * nq, dim)
            parts = []
            for i in range(nfe):
                f0q, f1q = vfs[i](tuple(uqs), tuple(guqs), xf)
                if ncs[i] == 1:
                    Fv = torch.einsum("cq,qv->cv", wdet * f0q.reshape(nc, nq), Bs[i]) \
                        + torch.einsum("cq,cqe,cqve->cv", wdet, f1q.reshape(nc, nq, dim),
                                       gDs[i])
                else:
                    Fv = (torch.einsum("cq,cqk,qv->cvk", wdet, f0q.reshape(nc, nq, ncs[i]),
                                       Bs[i])
                          + torch.einsum("cq,cqke,cqve->cvk", wdet,
                                         f1q.reshape(nc, nq, ncs[i], dim),
                                         gDs[i])).reshape(nc, -1)
                parts.append(Fv)
            return torch.cat(parts, dim=1)

        self._kern = element
        return element

    def _elements(self, u):
        tab = self._tables()
        ut = _as_device(u, self.ndof, tab["Jinv"].device, tab["Jinv"].dtype)
        ue = gather(ut, tab["conn"], check=False).reshape(len(self.conn), -1)
        return tab, ue

    def assembleResidual(self, u):
        """The coupled global residual, a tensor on the device."""
        tab, ue = self._elements(u)
        Fe = self._element_kernel()(ue, tab["Bs"], tab["Ds"], tab["Jinv"], tab["wdet"],
                                    tab["xq"])
        return dst_scatter(tab["scatter"], Fe.reshape(-1).contiguous())

    def elementJacobians(self, u):
        """(nc, nE, nE) on the device: column j the jvp along element dof j."""
        tab, ue = self._elements(u)
        element = self._element_kernel()
        args = (tab["Bs"], tab["Ds"], tab["Jinv"], tab["wdet"], tab["xq"])
        nE = ue.shape[1]

        def column(t):
            return torch.func.jvp(lambda v: element(v, *args), (ue,), (t,))[1]

        basis = torch.eye(nE, dtype=ue.dtype, device=ue.device)[:, None, :] \
            .expand(nE, ue.shape[0], nE)
        return torch.func.vmap(column)(basis).permute(1, 2, 0).contiguous()

    def assembleJacobian(self, u):
        """Coupled global Jacobian (a scipy CSR) — every per-field-pair
        block from the derivative of the concatenated element residual."""
        import scipy.sparse as sp
        Ke = host_array(self.elementJacobians(u))
        nE = self.conn.shape[1]
        rows = np.repeat(self.conn, nE, axis=1).reshape(-1)
        cols = np.tile(self.conn, (1, nE)).reshape(-1)
        return sp.csr_matrix((Ke.reshape(-1), (rows, cols)),
                             shape=(self.ndof, self.ndof))
