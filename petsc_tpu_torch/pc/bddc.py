"""PCBDDC: balancing domain decomposition by constraints on a MatIS.

Counterpart of ``petsc_tpu/pc/bddc.py`` (src/ksp/pc/impls/bddc), the SPD
two-level additive form

    M^-1 = sum_i R_i^T D_i Z_i D_i R_i  +  Phi Kc^-1 Phi^T,

Z_i the subdomain Neumann solve with the primal dofs pinned (K_qq^-1 on the
rest), Phi_i the harmonic coarse basis (Phi_p = I, Phi_q = -K_qq^-1 K_qp),
Kc the assembled primal coarse matrix and D_i = 1 / multiplicity. The
primal dofs are the reference's: the interface corners (multiplicity >= 3)
and, for a subdomain that has none, its first interface dof.

The set-up runs on the host (numpy), as the reference's; the tables are
padded as it lays them out: K_qq^-1 (ns, nl, nl), Phi (ns, nl, np). The
apply on the card: Phi^T (D r[G]) on D1's transposed form, the coarse
scatter-add on X1, Kc^-1 rc by ``torch.mv``, Phi xc on D1, the dual solve
K_qq^-1 (D r)[Qidx] on D1 (added into Phi xc at Qidx), and y = sum of
D zl by global row on X1. The same tables give fetidp's Ktilde^-1
(:mod:`petsc_tpu_torch.ksp.fetidp`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import operator, pc_kernels
from ..sys.error import Error
from .pc import PC


def primal_dofs(mult, maps):
    """The reference's primal selection (bddc.py:49-57): every dof of
    multiplicity >= 3, then, for each subdomain in turn that holds none yet,
    its first interface dof."""
    primal = np.zeros(len(mult), dtype=bool)
    primal[mult >= 3] = True
    for gi in maps:
        gi = np.asarray(gi, dtype=np.int64)
        if not primal[gi].any():
            iface = gi[mult[gi] >= 2]
            if len(iface):
                primal[iface[0]] = True
    return np.nonzero(primal)[0]


def bddc_tables(M):
    """The host set-up (bddc.py:35-108) as numpy arrays: G, D, the local
    sizes ks, the primal dofs' local positions per subdomain, K_qq^-1, Phi,
    Pg (each subdomain's primal dofs' coarse numbers), the counts np_s,
    nq_s, Qidx and Kc^-1."""
    mats, maps = M.getLocalMats()
    ns = len(mats)
    mult = M.interface_multiplicity()
    primal_glob = primal_dofs(mult, maps)
    g2p = np.full(len(mult), -1, dtype=np.int64)
    g2p[primal_glob] = np.arange(len(primal_glob))
    nP = len(primal_glob)
    ks = np.asarray([len(g) for g in maps], dtype=np.int64)
    nl = int(ks.max())
    nps = np.asarray([(g2p[np.asarray(g)] >= 0).sum() for g in maps], dtype=np.int64)
    npmax = int(nps.max())
    G = np.zeros((ns, nl), dtype=np.int64)
    D = np.zeros((ns, nl))
    Qidx = np.full((ns, nl), -1, dtype=np.int64)
    Kqq_inv = np.zeros((ns, nl, nl))
    Phi = np.zeros((ns, nl, npmax))
    Pg = np.zeros((ns, npmax), dtype=np.int64)
    Kc = np.zeros((nP, nP))
    nqs = ks - nps
    for s, (Ai, gi) in enumerate(zip(mats, maps)):
        K = Ai.toarray() if hasattr(Ai, "toarray") else np.asarray(Ai)
        gi = np.asarray(gi, dtype=np.int64)
        k = len(gi)
        G[s, :k] = gi
        D[s, :k] = 1.0 / mult[gi]
        isp = g2p[gi] >= 0
        p, q = np.nonzero(isp)[0], np.nonzero(~isp)[0]
        npi, nqi = len(p), len(q)
        Kqqi = np.linalg.inv(K[np.ix_(q, q)] + 1e-12 * np.eye(nqi))
        Kqq_inv[s, :nqi, :nqi] = Kqqi
        Qidx[s, :nqi] = q
        Ph = np.zeros((k, npi))
        Ph[p, np.arange(npi)] = 1.0
        if nqi and npi:
            Ph[q, :] = -Kqqi @ K[np.ix_(q, p)]
        Phi[s, :k, :npi] = Ph
        Pg[s, :npi] = g2p[gi[p]]
        idx = Pg[s, :npi]
        Kc[np.ix_(idx, idx)] += Ph.T @ K @ Ph
    Kc_inv = np.linalg.inv(Kc + 1e-12 * np.eye(nP))
    return dict(ns=ns, nl=nl, npmax=npmax, nP=nP, ks=ks, nps=nps, nqs=nqs, G=G, D=D,
                Qidx=Qidx, Kqq_inv=Kqq_inv, Phi=Phi, Pg=Pg, Kc_inv=Kc_inv, mult=mult)


def ktilde_tables(t, src_G, src_w, dev, rd):
    """The device tables of BDDC's apply for a source reached through
    src_G (ns, nl) with weights src_w (the global residual r[G] D for the
    PC; the local buffer itself for fetidp's Ktilde^-1)."""
    ns, nl, npmax = t["ns"], t["nl"], t["npmax"]
    ks, nps, nqs = t["ks"], t["nps"], t["nqs"]
    Qidx = t["Qidx"]
    qv = Qidx >= 0
    qsafe = np.where(qv, Qidx, 0)
    rows = np.arange(ns)[:, None]
    pv = np.arange(npmax)[None, :] < nps[:, None]
    wq = None if src_w is None else np.where(qv, src_w[rows, qsafe], 0.0)
    return {
        "Kqq_inv": torch.as_tensor(t["Kqq_inv"], dtype=rd, device=dev),
        "Phi": torch.as_tensor(t["Phi"], dtype=rd, device=dev),
        "Kc_inv": torch.as_tensor(t["Kc_inv"], dtype=rd, device=dev),
        "restrict": pc_kernels.subdomain_table(src_G, src_w, nr=ks, nc=nps, device=dev,
                                               dtype=rd),
        "coarse": pc_kernels.scatter_table(t["Pg"][pv], np.flatnonzero(pv), t["nP"],
                                           ns * npmax, device=dev, dtype=rd),
        "interp": pc_kernels.subdomain_table(t["Pg"], pv.astype(np.float64), nr=ks, nc=nps,
                                             device=dev, dtype=rd),
        "dual": pc_kernels.subdomain_table(np.where(qv, src_G[rows, qsafe], 0), wq, out=Qidx,
                                           nr=nqs, nc=nqs, device=dev, dtype=rd),
    }


def ktilde_apply(tab, src):
    """Phi Kc^-1 Phi^T src~ + the dual solves, as the local buffer (ns, nl)."""
    rc = pc_kernels.dst_scatter(
        tab["coarse"], pc_kernels.subdomain_apply(tab["Phi"], tab["restrict"], src,
                                                  transposed=True).view(-1))
    zl = pc_kernels.subdomain_apply(tab["Phi"], tab["interp"], torch.mv(tab["Kc_inv"], rc))
    return pc_kernels.subdomain_apply(tab["Kqq_inv"], tab["dual"], src, y=zl, accumulate=True)


class _PCBDDC:
    def __init__(self, pc):
        self.pc = pc

    def set_from_options(self):
        pass

    def setup(self):
        from ..mat.utility import MatIS
        M = self.pc.pmat
        if not isinstance(M, MatIS):
            raise Error("PCBDDC requires a MATIS operator "
                        "(MatIS.create with local Neumann matrices)")
        t = bddc_tables(M)
        dev, rd = config.device(), config.real_dtype()
        data = ktilde_tables(t, t["G"], t["D"], dev, rd)
        valid = np.arange(t["nl"])[None, :] < t["ks"][:, None]
        data["final"] = pc_kernels.scatter_table(t["G"][valid], np.flatnonzero(valid),
                                                 M.row_layout.Npad, t["ns"] * t["nl"],
                                                 t["D"][valid], device=dev, dtype=rd)
        return ("pc_bddc", t["ns"], t["nl"], t["npmax"], t["nP"]), data


def _bind_bddc(meta, data):
    def mult(r):
        return pc_kernels.dst_scatter(data["final"], ktilde_apply(data, r).view(-1))

    return operator.Op(mult=mult)


operator.register_binder("pc_bddc", _bind_bddc)
PC.register_impl("bddc", _PCBDDC)
