"""KSPFETIDP: dual-primal finite element tearing and interconnect.

Counterpart of ``petsc_tpu/ksp/fetidp.py`` (src/ksp/ksp/impls/fetidp): on
a MatIS, glue the primal dofs (BDDC's selection), tear the other interface
dofs, and solve the dual problem F lambda = d, F = B Ktilde^-1 B^T,
d = B Ktilde^-1 f, by CG preconditioned with the lumped B D K D B^T; then
u = Ktilde^-1 (f - B^T lambda), averaged over the copies. Ktilde^-1 is
BDDC's algebra (:func:`petsc_tpu_torch.pc.bddc.ktilde_apply`: Phi^T and
Phi on D1's two forms, the coarse scatter on X1, Kc^-1 by ``torch.mv``,
the dual solves on D1); B and B^T are X1's signed scatter over the jump
rows, the lumped preconditioner D1 on the local matrices with the scaling
folded into X1's weights, the dots K4 and the updates K2. The loop's
control stays on the host as the reference's (``host_driven``), with one
read of (p^T F p, ||r||, r^T z) per iteration; the vectors stay on b's
device. The jump rows are the reference's (each torn dof's first copy
against each later one, dofs in order of first appearance), built at once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config
from ..ops import pc_kernels
from ..ops.pallas_kernels import triad
from ..sys.error import Error, KSPConvergedReason as KR
from .common import dot, host, scalar


def jump_rows(t):
    """The reference's lam_rows (fetidp.py:60-89) as arrays (a, b) of local
    buffer slots s * nl + j: for each torn dof (multiplicity >= 2, not
    primal), in order of its first appearance over (subdomain, local dof),
    its first copy against each later one."""
    ns, nl, G, Qidx = t["ns"], t["nl"], t["G"], t["Qidx"]
    s_of = np.repeat(np.arange(ns), t["nqs"])
    j_of = Qidx[Qidx >= 0]
    gd = G[s_of, j_of]
    torn = t["mult"][gd] >= 2
    s_of, j_of, gd = s_of[torn], j_of[torn], gd[torn]
    # each entry's key: the index of its dof's first appearance
    _, first_idx, inv = np.unique(gd, return_index=True, return_inverse=True)
    order_key = first_idx[inv]
    order = np.argsort(order_key, kind="stable")
    slots, keys = (s_of * nl + j_of)[order], order_key[order]
    head = np.concatenate([[True], keys[1:] != keys[:-1]]) if len(keys) else np.zeros(0, bool)
    grp_first = np.maximum.accumulate(np.where(head, np.arange(len(keys)), 0))
    later = ~head
    return slots[grp_first[later]], slots[later]


def fetidp_tables(M, dev, rd):
    from ..pc.bddc import bddc_tables, ktilde_tables
    t = bddc_tables(M)
    ns, nl, ks = t["ns"], t["nl"], t["ks"]
    n = M.getSize()[0]
    valid = np.arange(nl)[None, :] < ks[:, None]
    flat = np.flatnonzero(valid)
    local = (np.arange(ns)[:, None] * nl + np.arange(nl)[None, :])
    a, b = jump_rows(t)
    nlam = len(a)
    lam = np.arange(nlam)
    cnt = np.bincount(t["G"][valid], minlength=n).astype(np.float64)
    D = t["D"]
    tab = ktilde_tables(t, local, None, dev, rd)
    tab.update(
        nlam=nlam, nloc=ns * nl,
        split=pc_kernels.scatter_table(flat, t["G"][valid], ns * nl, n, D[valid], device=dev,
                                       dtype=rd),
        Bt=pc_kernels.scatter_table(np.stack([a, b], 1).ravel(), np.repeat(lam, 2), ns * nl,
                                    nlam, np.tile([1.0, -1.0], nlam), device=dev, dtype=rd),
        B=pc_kernels.scatter_table(np.repeat(lam, 2), np.stack([a, b], 1).ravel(), nlam,
                                   ns * nl, np.tile([1.0, -1.0], nlam), device=dev, dtype=rd),
        BD=pc_kernels.scatter_table(np.repeat(lam, 2), np.stack([a, b], 1).ravel(), nlam,
                                    ns * nl, np.stack([D.ravel()[a], -D.ravel()[b]], 1).ravel(),
                                    device=dev, dtype=rd),
        lumped=pc_kernels.subdomain_table(local, D, nr=ks, nc=ks, device=dev, dtype=rd),
        gather_back=pc_kernels.scatter_table(t["G"][valid], flat, n, ns * nl,
                                             1.0 / np.maximum(cnt, 1.0)[t["G"][valid]],
                                             device=dev, dtype=rd))
    return tab


def tables_for(ksp, b):
    """The set-up of ksp's MatIS for b's dtype and device, kept on the KSP
    while the operator's state holds; its host seconds are the event
    KSPFETIDPSetUp."""
    M = ksp.mat
    key = (id(M), M.state, b.dtype, b.device)
    cached = getattr(ksp, "_fetidp", None)
    if cached is None or cached[0] != key:
        t0 = time.perf_counter()
        cached = ksp._fetidp = (key, fetidp_tables(M, b.device, b.dtype))
        config.log().log_event("KSPFETIDPSetUp", time.perf_counter() - t0)
    return cached[1]


def solve_fetidp_host(ksp, A, B, b, x0):
    """The dual CG of the reference's solve_fetidp_host (fetidp.py:101-190)
    on the device: returns (x, its, rnorm, reason, history, rnorm0)."""
    from ..mat.utility import MatIS
    M = ksp.mat
    if not isinstance(M, MatIS):
        raise Error("KSPFETIDP requires a MATIS operator")
    tab = tables_for(ksp, b)
    Ab = M.device_data()["Ab"].to(b.dtype)
    X = pc_kernels.dst_scatter

    def ktilde(f):
        from ..pc.bddc import ktilde_apply
        return ktilde_apply(tab, f).view(-1)

    def Fdot(lam):
        return X(tab["B"], ktilde(X(tab["Bt"], lam)))

    def Mprec(lam):
        return X(tab["BD"], pc_kernels.subdomain_apply(Ab, tab["lumped"], X(tab["Bt"], lam))
                 .view(-1))

    f_loc = X(tab["split"], b)
    d = X(tab["B"], ktilde(f_loc))
    lam = torch.zeros_like(d)
    r = d
    z = Mprec(r)
    p = z
    rz, rn2 = dot(r, z), dot(r, r)
    rz_h, rn2_h = host(rz, rn2)
    rnorm0 = float(np.sqrt(rn2_h))
    hist = [rnorm0]
    its, reason = 0, 0
    ttol = max(ksp.rtol * rnorm0, ksp.abstol)
    if tab["nlam"] == 0 or rnorm0 == 0.0:
        reason = int(KR.CONVERGED_ATOL)
    while reason == 0 and its < ksp.max_it:
        Fp = Fdot(p)
        denom = dot(p, Fp)
        alpha = rz / denom
        lam_new = triad(lam, p, alpha)
        r_new = triad(r, Fp, -alpha)
        z_new = Mprec(r_new)
        rz_new, rn2 = dot(r_new, z_new), dot(r_new, r_new)
        denom_h, rn2_h, rz_new_h = host(denom, rn2, rz_new)
        if denom_h <= 0:
            reason = int(KR.DIVERGED_INDEFINITE_MAT)
            break
        lam, r = lam_new, r_new
        its += 1
        rn = float(np.sqrt(rn2_h))
        hist.append(rn)
        if rn <= ttol:
            reason = int(KR.CONVERGED_ATOL if rn < ksp.abstol else KR.CONVERGED_RTOL)
            break
        p = triad(z_new, p, rz_new / rz)
        rz = rz_new
    if reason == 0:
        reason = int(KR.DIVERGED_ITS)
    w = ktilde(triad(f_loc, X(tab["Bt"], lam), scalar(-1.0, f_loc)))
    x = X(tab["gather_back"], w)
    return x, its, hist[-1], reason, hist, rnorm0
