"""More SNES types: fas, vinewtonrsls/ssls, ncg, composite, ngs, nasm,
aspin, patch and ms.

Counterpart of ``petsc_tpu/snes/impls_more.py`` (reference
src/snes/impls/fas: pre-smooth, restrict state and residual, tau-corrected
coarse solve, prolong the correction, post-smooth; impls/vi/rs: active-set
reduced-space Newton with projection onto [xl, xu]; impls/ncg;
impls/composite; impls/ngs; impls/nasm and aspin; impls/patch; impls/ms).
Iterates are tensors on the Vec's device; Jacobian diagonals and patch
Jacobians come from ``torch.func`` (jvp probes, vmap of jacfwd).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import vecops as V
from ..sys.error import Error, SNESConvergedReason as SR
from .snes import SNES, _end, _finish, _ksp_solve_newton, _with_ls


# ---------------------------------------------------------------------
# FAS: nonlinear multigrid (full approximation scheme)
# ---------------------------------------------------------------------

def solve_fas(snes: SNES, x, xvec):
    """FAS V-cycles. Needs a DMDA on snes.dm and snes.fas_residual_factory
    = lambda da: residual_fn, a pure residual on each level."""
    das, residuals = _fas_hierarchy(snes)
    nlev = len(das)
    smooth_its = 4
    from ..ops import operator

    def smooth(lvl, u, b, its):
        """Damped nonlinear Jacobi u += 0.6 D(u)^-1 (b - F(u)), with the
        Jacobian diagonal from 2^dim colouring jvp probes."""
        f = residuals[lvl]
        d = _fas_node_diag(f, u, tuple(das[lvl].sizes[::-1]))
        d = torch.where(d.abs() < 1e-12, torch.ones_like(d), d)
        for _ in range(its):
            r = b - f(u)
            u = u + 0.6 * r / d
        return u

    def cycle(lvl, u, b):
        f = residuals[lvl]
        if lvl == nlev - 1:
            return smooth(lvl, u, b, 20)
        u = smooth(lvl, u, b, smooth_its)
        r = b - f(u)
        P = das[lvl].createInterpolation(das[lvl + 1])
        Pop = operator.bind(P.meta, P.device_data())
        # full-weighting restriction: P^T scaled for the rediscretised
        # coarse operators (classical FD-FAS)
        rc = V.flat(Pop.mult_t(r)) * getattr(snes, "fas_rscale", 0.75)
        # state restriction by injection (DMCreateInjection)
        uc0 = das[lvl].createInjection(das[lvl + 1])(u)
        tau = residuals[lvl + 1](uc0) + rc          # FAS tau correction
        uc = cycle(lvl + 1, uc0.clone(), tau)
        u = u + V.flat(Pop.mult(V.flat(uc - uc0)))
        return smooth(lvl, u, b, smooth_its)

    f0 = residuals[0]
    fnorm = V.norm(f0(x))
    snes._fnorm0 = fnorm
    snes._ttol = snes.rtol * fnorm
    snes._monitor(0, fnorm)
    reason = snes._converged(0, 0.0, 0.0, fnorm)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        xn = cycle(0, x.clone(), torch.zeros_like(x))
        snorm = V.norm(V.axpy(xn, -1.0, x))
        x = xn
        fnorm = V.norm(f0(x))
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def _fas_hierarchy(snes):
    dm = snes.dm
    if dm is None:
        raise Error("SNES fas: attach a DMDA via setDM")
    das = [dm]
    while len(das) < getattr(snes, "fas_levels", 3):
        try:
            das.append(das[-1].coarsen())
        except Error:
            break
    factory = getattr(snes, "fas_residual_factory", None)
    if factory is None:
        raise Error("SNES fas: set snes.fas_residual_factory = "
                    "lambda da: residual_fn")
    residuals = []
    for da in das:
        fn = factory(da)
        residuals.append(lambda u, fn=fn: V.flat(fn(u)))
    return das, residuals


def _fas_node_diag(f, u, shape):
    """diag(J(u)) by 2^dim distance-1 colouring probes of torch.func.jvp:
    exact for residual stencils of width <= 1."""
    grids = np.indices(shape)
    color = np.zeros(shape, dtype=np.int64)
    for ax in range(len(shape)):
        color |= (grids[ax] % 2) << ax
    color = torch.as_tensor(color.reshape(-1), device=u.device)
    d = torch.zeros_like(u)
    for c in range(2 ** len(shape)):
        e = (color == c).to(u.dtype)
        Je = V.flat(torch.func.jvp(f, (u,), (e,))[1])
        d = torch.where(color == c, Je, d)
    return d


# ---------------------------------------------------------------------
# VI: reduced-space active-set Newton (vinewtonrsls)
# ---------------------------------------------------------------------

def solve_vinewtonrsls(snes: SNES, x, xvec):
    """Box-constrained VI (impls/vi/rs/virs.c): the active set is the
    bounds with an outward F; Newton on the inactive reduced system (the
    reduced matrix made on the host); projected backtracking."""
    from ..mat.aij import MatAIJ
    xl = getattr(snes, "vi_lower", None)
    xu = getattr(snes, "vi_upper", None)
    if xl is None and xu is None:
        raise Error("vinewtonrsls: call setVariableBounds")
    xl = torch.full_like(x, -np.inf) if xl is None else V.as_tensor(xl, like=x)
    xu = torch.full_like(x, np.inf) if xu is None else V.as_tensor(xu, like=x)
    x = torch.clamp(x, xl, xu)

    def vi_fnorm(xv, F):
        act_lo = (xv <= xl + 1e-12) & (F > 0)
        act_hi = (xv >= xu - 1e-12) & (F < 0)
        act = act_lo | act_hi
        return V.norm(torch.where(act, torch.zeros_like(F), F)), ~act

    F = snes._eval_F(x)
    fnorm, inact = vi_fnorm(x, F)
    snes._fnorm0 = fnorm
    snes._ttol = snes.rtol * fnorm
    snes._monitor(0, fnorm)
    reason = snes._converged(0, 0.0, 0.0, fnorm)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        J, P = snes.computeJacobian(x)
        # reduced system: inactive rows and columns, identity on the active
        Ps = P.to_scipy().tolil()
        for a in np.nonzero(~inact.cpu().numpy())[0]:
            Ps.rows[a] = [a]
            Ps.data[a] = [1.0]
        Jr = MatAIJ.from_scipy(Ps.tocsr(), comm=snes.comm)
        Fa = torch.where(inact, F, torch.zeros_like(F))
        y = _ksp_solve_newton(snes, Fa, Jr, Jr)
        if y is None:
            reason = SR.DIVERGED_LINEAR_SOLVE
            break
        lam = 1.0
        ok = False
        for _ in range(25):
            xn = torch.clamp(V.axpy(x, -lam, y), xl, xu)
            Fn = snes._eval_F(xn)
            gnorm, inact_n = vi_fnorm(xn, Fn)
            if gnorm <= (1.0 - 1e-4 * lam) * fnorm or gnorm < 1e-14:
                ok = True
                break
            lam *= 0.5
        if not ok and gnorm >= fnorm:
            reason = SR.DIVERGED_LINE_SEARCH
            break
        snorm = V.norm(V.axpy(xn, -1.0, x))
        x, F, fnorm, inact = xn, Fn, gnorm, inact_n
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def setVariableBounds(snes, xl, xu):
    from ..vec.vec import Vec
    snes.vi_lower = np.asarray(xl.getArray() if isinstance(xl, Vec) else xl)
    snes.vi_upper = np.asarray(xu.getArray() if isinstance(xu, Vec) else xu)
    return snes


SNES.setVariableBounds = setVariableBounds


# ---------------------------------------------------------------------
# ncg: nonlinear conjugate gradients on F
# ---------------------------------------------------------------------

def solve_ncg(snes: SNES, x, xvec):
    """Nonlinear CG (impls/ncg, PRP+ beta) with F as the gradient."""
    ls = snes.linesearch
    old = _with_ls(snes, "cp")
    F, fnorm, reason = snes._start(x)
    d = F.clone()
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        xn, Fn, gnorm, lam, ok = ls.apply(x, d, F, fnorm)
        if not ok and gnorm >= fnorm:
            d = F.clone()
            xn, Fn, gnorm, lam, ok = ls.apply(x, d, F, fnorm)
            if not ok and gnorm >= fnorm:
                reason = SR.DIVERGED_LINE_SEARCH
                break
        beta = max(0.0, V.dot(Fn, V.axpy(Fn, -1.0, F)) / V.normsq(F))
        d = V.axpy(Fn, beta, d)
        snorm = V.norm(V.axpy(xn, -1.0, x))
        x, F, fnorm = xn, Fn, gnorm
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    ls.kind = old
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


# ---------------------------------------------------------------------
# composite: sub-solvers in sequence
# ---------------------------------------------------------------------

def solve_composite(snes: SNES, x, xvec):
    """Multiplicative composite (impls/composite): each sub-solver of
    snes.composite_types (default nrichardson, newtonls) for two
    iterations per outer sweep."""
    from ..vec.vec import Vec
    subs = getattr(snes, "composite_types", ["nrichardson", "newtonls"])
    F, fnorm, reason = snes._start(x)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        x_old = x.clone()
        for st in subs:
            sub = SNES(options=snes._options)
            sub.create(snes.comm)
            sub.setType(st)
            if snes._func_pure is not None:
                sub.setFunction(snes._func_pure)
            else:
                sub.setFunction(snes._func, f=snes._fvec)
            if snes._jac is not None:
                sub.setJacobian(snes._jac, J=snes._jac_mat, P=snes._jac_pmat)
            sub.max_it = 2
            xv = Vec.from_array(x, comm=snes.comm)
            sub.solve(None, xv)
            x = V.flat(xv.array)
        F = snes._eval_F(x)
        fnorm = V.norm(F)
        snorm = V.norm(V.axpy(x, -1.0, x_old))
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


# ---------------------------------------------------------------------
# ngs: coloured secant nonlinear Gauss-Seidel
# ---------------------------------------------------------------------

def solve_ngs(snes: SNES, x, xvec):
    """Nonlinear Gauss-Seidel by coloured secant sweeps
    (SNESComputeNGSDefaultSecant, impls/ngs): per colour one residual
    probe estimates the pointwise Jacobian diagonal, and the colour's
    unknowns take their Newton update together."""
    colors = torch.as_tensor(_ngs_colors(snes, x.numel()), device=x.device)
    ncolor = int(colors.max()) + 1
    h = 1e-8
    sweeps = getattr(snes, "ngs_sweeps", 1)
    F, fnorm, reason = snes._start(x)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        x_old = x.clone()
        for _ in range(sweeps):
            for c in range(ncolor):
                sel = colors == c
                F = snes._eval_F(x)
                Fp = snes._eval_F(x + h * sel.to(x.dtype))
                d = (Fp - F)[sel] / h
                d = torch.where(d.abs() < 1e-30, torch.ones_like(d), d)
                x = x.clone()
                x[sel] -= F[sel] / d
        F = snes._eval_F(x)
        fnorm = V.norm(F)
        snorm = V.norm(V.axpy(x, -1.0, x_old))
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def _ngs_colors(snes, n):
    dm = snes.dm
    if dm is not None and getattr(dm, "sizes", None) is not None:
        shape = tuple(dm.sizes[::-1])
        grids = np.indices(shape)
        color = np.zeros(shape, dtype=np.int64)
        for ax in range(len(shape)):
            color |= (grids[ax] % 2) << ax
        return color.reshape(-1)
    if snes._jac_pmat is not None and snes._jac_pmat.nnz() > 0:
        from ..mat.fdcoloring import MatFDColoring
        return MatFDColoring(snes._jac_pmat).colors      # greedy on S^T S
    return np.zeros(n, dtype=np.int64)   # dense fallback: damped Jacobi


# ---------------------------------------------------------------------
# nasm / aspin: nonlinear additive Schwarz
# ---------------------------------------------------------------------

def _nasm_subdomains(snes, n):
    nb = getattr(snes, "nasm_blocks", 2)
    ov = getattr(snes, "nasm_overlap", 1)
    sizes = np.full(nb, n // nb)
    sizes[: n % nb] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)])
    doms = []
    for b in range(nb):
        lo = max(0, starts[b] - ov)
        hi = min(n, starts[b + 1] + ov)
        doms.append((np.arange(starts[b], starts[b + 1]), np.arange(lo, hi)))
    return doms


def _nasm_correction(snes, x, doms):
    """Additive Schwarz corrections (impls/nasm): each restricted
    nonlinear subproblem solved by a small inner Newton; the restricted
    (owned-part) combination."""
    from ..vec.vec import Vec
    d_total = torch.zeros_like(x)
    for own, dom in doms:
        base = x.clone()
        dom_t = torch.as_tensor(dom, device=x.device)

        def local_res(z, dom_t=dom_t, base=base):
            xz = base.index_put((dom_t,), z)
            F = snes._func_pure(xz) if snes._func_pure is not None else snes._eval_F(xz)
            return V.flat(F)[dom_t]

        sub = SNES(options=snes._options)
        sub.create(snes.comm)
        sub.setType("newtonls")
        sub.setFunction(lambda z: local_res(z))      # pure: one parameter
        sub.max_it = getattr(snes, "nasm_sub_its", 6)
        sub.rtol = 1e-3
        zv = Vec.from_array(x[dom_t], comm=snes.comm)
        sub.solve(None, zv)
        corr = V.flat(zv.array) - x[dom_t]
        sel = np.isin(dom, own)
        d_total[dom_t[torch.as_tensor(sel, device=x.device)]] += \
            corr[torch.as_tensor(sel, device=x.device)]
    return d_total


def solve_nasm(snes: SNES, x, xvec):
    """Nonlinear additive Schwarz (impls/nasm; restricted combination)."""
    doms = _nasm_subdomains(snes, x.numel())
    damping = getattr(snes, "nasm_damping", 1.0)
    F, fnorm, reason = snes._start(x)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        d = _nasm_correction(snes, x, doms)
        x = V.axpy(x, damping, d)
        F = snes._eval_F(x)
        fnorm = V.norm(F)
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), damping * V.norm(d), fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


def solve_aspin(snes: SNES, x, xvec):
    """ASPIN (aspin.c role): line-searched outer iteration on the
    additive-Schwarz-preconditioned direction."""
    doms = _nasm_subdomains(snes, x.numel())
    ls = snes.linesearch
    old = _with_ls(snes, "l2")
    F, fnorm, reason = snes._start(x)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        d = _nasm_correction(snes, x, doms)
        xn, Fn, gnorm, lam, ok = ls.apply(x, -d, F, fnorm)
        if not ok and gnorm >= fnorm:
            reason = SR.DIVERGED_LINE_SEARCH
            break
        snorm = V.norm(V.axpy(xn, -1.0, x))
        x, F, fnorm = xn, Fn, gnorm
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    ls.kind = old
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


# ---------------------------------------------------------------------
# patch: vertex-star nonlinear patch relaxation, batched
# ---------------------------------------------------------------------

def _patch_subdomains(snes, n):
    """Vertex-star patches (SNESPATCH role): one patch per dof over its
    pattern neighbours (snes.patch_pattern or the SNES's P), else
    +-patch_size windows."""
    A = getattr(snes, "patch_pattern", None) or getattr(snes, "_jac_pmat", None)
    if A is not None and hasattr(A, "to_scipy"):
        S = A.to_scipy().tocsr()
        doms = []
        for i in range(n):
            nbr = np.unique(np.concatenate(
                [[i], S.indices[S.indptr[i]:S.indptr[i + 1]]]))
            doms.append((np.asarray([i]), nbr[nbr < n]))
        return doms
    ps = getattr(snes, "patch_size", 2)
    return [(np.asarray([i]), np.arange(max(0, i - ps), min(n, i + ps + 1)))
            for i in range(n)]


def _patch_correction_batched(snes, x, doms, sub_its):
    """All patches of one size as one batched Newton: torch.func.vmap over
    the patches of sub_its steps of jacfwd + solve; each patch gives only
    its centre dof's correction. Needs a pure residual."""
    fp = snes._func_pure
    if fp is None:
        raise Error("SNES patch: set a pure torch residual (setFunction)")
    base = x
    d_total = torch.zeros_like(x)
    groups = {}
    for own, dom in doms:
        groups.setdefault(len(dom), []).append((int(own[0]), dom))
    for sz, g in groups.items():
        D = torch.as_tensor(np.stack([dom for _, dom in g]), device=x.device)
        centers = torch.as_tensor(np.asarray([c for c, _ in g]), device=x.device)
        cpos = torch.as_tensor(np.stack([np.searchsorted(dom, c) for c, dom in g]),
                               device=x.device)
        eye = torch.eye(sz, dtype=x.dtype, device=x.device)

        def one(dom, cp):
            z0 = base[dom]

            def res(z):
                return V.flat(fp(base.scatter(0, dom, z)))[dom]

            z = z0
            for _ in range(sub_its):
                r = res(z)
                Jl = torch.func.jacfwd(res)(z)
                z = z - torch.linalg.solve(Jl + 1e-14 * eye, r)
            return (z - z0)[cp]

        corr = torch.func.vmap(one)(D, cpos)
        d_total = d_total.index_add(0, centers, corr)
    return d_total


def solve_patch(snes: SNES, x, xvec):
    """SNESPATCH: nonlinear additive patch relaxation over vertex-star
    patches, batched by patch size (each patch updates its centre)."""
    doms = _patch_subdomains(snes, x.numel())
    damping = getattr(snes, "patch_damping", 1.0)
    sub_its = getattr(snes, "patch_sub_its", 3)
    F, fnorm, reason = snes._start(x)
    it = 0
    while reason == SR.ITERATING and it < snes.max_it:
        d = _patch_correction_batched(snes, x, doms, sub_its)
        x = V.axpy(x, damping, d)
        F = snes._eval_F(x)
        fnorm = V.norm(F)
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), damping * V.norm(d), fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


# ---------------------------------------------------------------------
# ms: multi-stage smoothing
# ---------------------------------------------------------------------

def solve_ms(snes: SNES, x, xvec):
    """Multi-stage (RK-type) smoothing on F(x) = 0 (impls/ms, the 3-stage
    scheme with Jacobi scaling): x <- x0 - a_i tau D^-1 F(x)."""
    stages = getattr(snes, "ms_stages", (0.1481, 0.4, 1.0))
    tau = getattr(snes, "ms_damping", 0.6)
    F, fnorm, reason = snes._start(x)
    it = 0
    dm = snes.dm
    while reason == SR.ITERATING and it < snes.max_it:
        if dm is not None and getattr(dm, "sizes", None) is not None \
                and snes._func_pure is not None:
            fp, args = snes._func_pure, snes._func_args
            d = _fas_node_diag(lambda u: V.flat(fp(u, *args)), x, tuple(dm.sizes[::-1]))
            d = torch.where(d.abs() < 1e-12, torch.ones_like(d), d)
        else:
            d = torch.ones_like(x)
        x0 = x.clone()
        for a in stages:
            Fs = snes._eval_F(x)
            x = x0 - a * tau * Fs / d
        F = snes._eval_F(x)
        fnorm = V.norm(F)
        snorm = V.norm(V.axpy(x, -1.0, x0))
        it += 1
        snes._monitor(it, fnorm)
        reason = snes._converged(it, V.norm(x), snorm, fnorm)
    _finish(snes, xvec, x, it, fnorm, _end(snes, reason))


SNES._impls.update({
    "ms": solve_ms,
    "nasm": solve_nasm,
    "patch": solve_patch,
    "aspin": solve_aspin,
    "ngs": solve_ngs,
    "fas": solve_fas,
    "vinewtonrsls": solve_vinewtonrsls,
    "vinewtonssls": solve_vinewtonrsls,
    "ncg": solve_ncg,
    "composite": solve_composite,
})

