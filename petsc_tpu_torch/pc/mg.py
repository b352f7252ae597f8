"""PCMG: the multigrid preconditioner (V, W, full and kaskade cycles).

Counterpart of ``petsc_tpu/pc/mg.py`` (reference src/ksp/pc/impls/mg/mg.c:
PCMGMCycle_Private :14, the recursive cycle of pre-smoothing, residual,
restriction, coarse correction, interpolation and post-smoothing;
PCApply_MG :648; the PCMGSetLevels/SetInterpolation/SetCycleType API).

Level 0 is the finest (PETSc numbers 0 the coarsest; ``view`` converts).
The hierarchy is built on the host: Galerkin coarse operators by the
native SpGEMM (``MatAIJ.ptap``), Chebyshev bounds by a host Arnoldi,
the coarse LU by scipy. The cycle runs on the card:
* smoothing: Chebyshev with Jacobi inside, each step one S2 product and
  one launch of the fused update C1 (:mod:`..ksp.cheby`);
* residual ``b - A x`` and correction ``x + P x_c``: the level's product
  (S2, or S1 and V1 on grid stencils, Q1P for a Q1 P), then K2 triad;
* restriction: a Q1 interpolation (``interp_q1``) restricts with its own
  gather-form transpose, the kernel Q1R, as the reference does
  (mg.py:359-364); any other P by S2 on an explicit host transpose
  ``R = P^T`` (``native.csr_transpose``), not ``P.mult_t``, whose
  ``index_add_`` atomics sum in an order that changes from run to run.
  The reference's restriction is also ``P^T``, so the two agree to
  rounding;
* coarse solve: the dense LU factor of ``scipy.linalg.lu_factor`` (the
  reference's), solved on the card by ``torch.linalg.lu_solve`` (the
  reference solves outside Pallas too, mg.py:487), or Jacobi CG.
Under ``-pc_mg_dtype single`` the whole cycle runs in float32 inside the
float64 Krylov method.

With ``-pc_gamg_asm_use_agg`` a GAMG level smooths with the
aggregate-block PC in place of Jacobi (PCASM over the aggregates with
exact sub-solves, mg.py:121-169): the dense inverse of the operator's
diagonal block over each aggregate's dofs, stored ragged (each inverse at
an offset in one flat array beside its dof list; the reference pads every
block to the largest, 425 GiB at ex56 ne 40), applied by the hand kernel
A1 (:func:`..ops.block_kernels.agg_block_apply`), whose fused entry
(:func:`..ops.block_kernels.agg_block_cheby`) finishes each smoothing
step at its stores, so a step's tail is one launch; the level's Chebyshev
bounds are those of M^-1 A by the host Arnoldi through that PC.

The one-device port has no padded layouts, so the reference's ``_fit``
around the transfers is the identity and is gone. With no levels given
and an operator from ``DMDA.createMatrix`` (``_build_from_dm``), the
levels come from the DMDA: ``-pc_mg_levels`` or coarsening down to 50
rows, each coarse operator rediscretized by the DM's callback or else the
Galerkin product, the transfers ``MatInterpQ1`` (Q1P/Q1R, per component
for dof > 1). A refined DMPlex behind the operator (``assemblePoissonP1``)
gives its refinement chain the same way, with the interpolations
``refine()`` recorded (MatAIJ, S2) and Galerkin coarse operators. PCGAMG
(:mod:`.gamg`) builds its hierarchy by aggregation and reuses the rest.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config, native
from ..ksp.cheby import cheby_smooth, cheby_smooth4, pc_step
from ..ops import operator
from ..ops.block_kernels import (agg_block_apply, agg_block_apply_plain, agg_block_cheby,
                                 agg_block_tables, size_runs)
from ..ops.pallas_kernels import cheby_update, dot2, triad
from ..parallel.mesh import reducing
from ..sys.error import Error
from .pc import PC


# ---------------------------------------------------------------------
# hierarchy containers (host side)
# ---------------------------------------------------------------------

class MGLevelSpec:
    """One level of the hierarchy (host-side plan)."""

    def __init__(self, A, P=None, R=None, emax=None, emin=None):
        self.A = A          # Mat (level operator)
        self.P = P          # interpolation: next coarser level -> this level (None on the coarsest)
        self.R = R          # restriction (default P^T)
        self.emax = emax    # Chebyshev bounds (floats)
        self.emin = emin
        self.agg = None     # GAMG: the nodal aggregates that coarsened this level
        self.agg_bs = 1     # (the -pc_gamg_asm_use_agg smoother blocks)


def _host_emax(A_sp, dinv, iters=10, seed=7):
    """Largest Ritz value of D^-1 A from a 10-step Arnoldi on the host
    with numpy's ``default_rng(seed)`` start, classical Gram-Schmidt with
    one reorthogonalization and the native row-parallel matvec: the
    reference's function, bit for bit (agg.c:1855-1899, cheby.c noisy-start
    estimation)."""
    rng = np.random.default_rng(seed)
    n = A_sp.shape[0]
    m = min(iters, n)
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    v = rng.random(n) - 0.5
    V[0] = v / np.linalg.norm(v)
    mv = native.csr_matvec_op(A_sp.tocsr())
    for j in range(m):
        w = dinv * mv(V[j])
        for _ in range(2):
            c = V[:j + 1] @ w
            H[:j + 1, j] += c
            w -= c @ V[:j + 1]
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] < 1e-14:
            m = j + 1
            break
        V[j + 1] = w / H[j + 1, j]
    ritz = np.linalg.eigvals(H[:m, :m])
    return max(float(np.max(np.abs(ritz))), 1e-12)


def _host_eig_bounds(A_sp_mult, dinv, n, iters=10, seed=7):
    """(emin, emax) Ritz estimates of D^-1 A from a host Arnoldi sweep
    (modified Gram-Schmidt), the KSPComputeExtremeSingularValues role."""
    rng = np.random.default_rng(seed)
    m = min(iters, n)
    V = np.zeros((n, m + 1))
    H = np.zeros((m + 1, m))
    v = rng.random(n) - 0.5
    V[:, 0] = v / np.linalg.norm(v)
    for j in range(m):
        w = dinv * A_sp_mult(V[:, j])
        for i in range(j + 1):
            H[i, j] = np.dot(V[:, i], w)
            w -= H[i, j] * V[:, i]
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] < 1e-14:
            m = j + 1
            break
        V[:, j + 1] = w / H[j + 1, j]
    ritz = np.linalg.eigvals(H[:m, :m]).real
    ritz = ritz[ritz > 0] if (ritz > 0).any() else np.abs(ritz)
    return max(float(ritz.min()), 1e-12), max(float(ritz.max()), 1e-12)


def _agg_blocks_host(A_sp, agg, bs):
    """The aggregate-block smoother's blocks on the host, ragged (the
    reference's _agg_block_tables, mg.py:121-160, without the padding): the
    dofs of each aggregate (node v carries dofs v bs ... v bs + bs - 1),
    then each dof outside every aggregate as a block of its own; blocks
    ordered by size (stable), each one's dofs ascending. Returns (the dof
    lists, the inverses of the operator's diagonal blocks row-major one
    after the other, np.linalg.inv, or pinv for a singular block)."""
    n = A_sp.shape[0]
    agg = np.asarray(agg, dtype=np.int64)
    nagg = int(agg.max()) + 1 if len(agg) else 0
    dof_agg = np.repeat(agg, bs)
    loose = dof_agg < 0
    blk = np.where(loose, nagg + np.cumsum(loose) - 1, dof_agg)
    counts = np.bincount(blk, minlength=nagg + int(loose.sum()))
    used = np.flatnonzero(counts)                 # empty aggregates are dropped
    border = used[np.argsort(counts[used], kind="stable")]
    rank = np.full(len(counts), -1, dtype=np.int64)
    rank[border] = np.arange(len(border))
    ks = counts[border]
    dofs = np.argsort(rank[blk], kind="stable")   # dofs ascending within a block
    dptr = np.concatenate([[0], np.cumsum(ks)])
    pos = np.empty(n, dtype=np.int64)
    pos[dofs] = np.arange(n) - np.repeat(dptr[:-1], ks)
    iptr = np.concatenate([[0], np.cumsum(ks * ks)])
    A = A_sp.tocsr()
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    rb, cb = rank[blk[rows]], rank[blk[A.indices]]
    inside = rb == cb
    inv = np.zeros(int(iptr[-1]))
    r_in = rows[inside]
    inv[iptr[rb[inside]] + pos[r_in] * ks[rb[inside]] + pos[A.indices[inside]]] = \
        A.data[inside]
    for lo, hi in size_runs(ks):
        k = int(ks[lo])
        M = inv[iptr[lo]:iptr[hi]].reshape(hi - lo, k, k)
        try:
            M[:] = np.linalg.inv(M)
        except np.linalg.LinAlgError:
            for a in range(hi - lo):
                try:
                    M[a] = np.linalg.inv(M[a])
                except np.linalg.LinAlgError:
                    # a degenerate block (decoupled or zero rows): the
                    # pseudo-inverse keeps the smoother defined
                    M[a] = np.linalg.pinv(M[a])
    return np.split(dofs, dptr[1:-1]), inv


def _dense_lu_factor(A_sp):
    import scipy.linalg as sla
    return sla.lu_factor(A_sp.toarray())


def _inv_diag(d):
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)


def _diag_vector(A):
    """A's diagonal as a vector: a constant stencil keeps one scalar, which
    the smoother's fused update (a vector dinv) takes expanded."""
    d = A.op().diag()
    return d.expand(A.getSize()[0]) if d.dim() == 0 else d


def _timed(name, fn, *args):
    """fn(*args), its host seconds logged as event `name`."""
    t0 = time.perf_counter()
    out = fn(*args)
    config.log().log_event(name, time.perf_counter() - t0)
    return out


class _PCMG:
    """PCMG with the hierarchy given through the PCMG API (geometric MG)."""

    def __init__(self, pc):
        self.pc = pc
        self.levels: list[MGLevelSpec] | None = None
        self.cycle = "v"
        self.smooth_pre = 2
        self.smooth_post = 2
        self.smoother = "chebyshev"   # chebyshev | fourth | opt_fourth | richardson (Jacobi inside)
        self.levels_pc = "jacobi"
        self.coarse_solver = "lu"     # lu | cg_jacobi
        # esteig transform (a, b, c, d): emin = a emin_est + b emax_est,
        # emax = c emin_est + d emax_est (cheby.c:203, the MG default)
        self.esteig_tform = (0.0, 0.1, 0.0, 1.1)
        # -pc_mg_dtype single: the whole cycle in float32 inside the
        # float64 Krylov method
        self.dtype = None

    def set_from_options(self):
        o = self.pc.opt
        c = o("get_string", "pc_mg_cycle_type", None)
        if c:
            self.cycle = c
        t = o("get_string", "pc_mg_type", None)
        if t in ("full", "kaskade", "kascade"):
            self.cycle = "full" if t == "full" else "kaskade"
        n = o("get_int", "mg_levels_ksp_max_it", None)
        if n:
            self.smooth_pre = self.smooth_post = n
        t = o("get_string", "mg_levels_ksp_type", None)
        if t:
            self.smoother = t
        t = o("get_string", "mg_levels_ksp_chebyshev_esteig", None)
        if t:
            vals = [float(x) for x in t.split(",")]
            self.esteig_tform = tuple(vals + [0.0] * (4 - len(vals)))[:4]
        if o("get_bool", "pc_gamg_asm_use_agg", False):
            self.levels_pc = "asm_agg"
        ct = o("get_string", "mg_coarse_ksp_type", None)
        cp = o("get_string", "mg_coarse_pc_type", None)
        if ct == "cg" and cp in (None, "jacobi"):
            self.coarse_solver = "cg_jacobi"
        t = o("get_string", "pc_mg_dtype", None)
        if t in ("single", "float32", "f32"):
            self.dtype = "f32"
        elif t in ("double", "float64", "f64"):
            self.dtype = None

    # ---- PCMG API (geometric path) ----

    def setLevels(self, n):
        self.levels = [MGLevelSpec(None) for _ in range(n)]

    def setInterpolation(self, finest_first_idx, P):
        self.levels[finest_first_idx].P = P

    def setOperator(self, finest_first_idx, A):
        self.levels[finest_first_idx].A = A

    def build_hierarchy(self):
        """Fill in the level operators by Galerkin RAP where missing, and
        the Chebyshev bounds where not given. Host seconds are logged as
        the events PCMGSetUp_download (the fine values from the card),
        PCMGSetUp_native (the build of graphops.cpp, where this is its
        first use), PCMGSetUp_SpGEMM, PCMGSetUp_emax."""
        if self.levels is None:
            if getattr(self.pc.pmat, "_dm", None) is None:
                raise Error("PCMG: call setLevels and setInterpolation, attach a DM "
                            "(KSP.setDM, or a matrix from DMDA.createMatrix), or use "
                            "-pc_type gamg")
            self._build_from_dm(self.pc.pmat._dm)
        if self.levels[0].A is None:
            self.levels[0].A = self.pc.pmat
        sync = getattr(self.levels[0].A, "_sync_host_vals", None)
        if sync is not None:
            # values that setValuesCOO left on the card come to the host once
            _timed("PCMGSetUp_download", sync)
        _timed("PCMGSetUp_native", native.lib)
        for lev in self.levels[1:]:
            # a rediscretized level's values are on the card too
            sync = getattr(lev.A, "_sync_host_vals", None)
            if sync is not None:
                _timed("PCMGSetUp_download", sync)
        for l in range(1, len(self.levels)):
            if self.levels[l].A is None:
                Pl = self.levels[l - 1].P
                if Pl is None:
                    raise Error(f"PCMG: no interpolation onto level {l - 1}")
                self.levels[l].A = _timed("PCMGSetUp_SpGEMM", self.levels[l - 1].A.ptap, Pl)
        for lev in self.levels[:-1]:
            if lev.emax is None and self.smoother == "chebyshev":
                A_sp = lev.A.to_scipy()
                d = A_sp.diagonal()
                dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
                emax = _timed("PCMGSetUp_emax", _host_emax, A_sp, dinv)
                lev.emin, lev.emax = self.eig_bounds(emax)

    def eig_bounds(self, emax_est, emin_est=0.0):
        """Apply the esteig transform to estimated D^-1 A bounds."""
        a, b, c, d = self.esteig_tform
        return (a * emin_est + b * emax_est, c * emin_est + d * emax_est)

    def _build_from_dm(self, dm):
        """The levels from a DM (mg.py:275-298), a DMDA or a refined DMPlex
        (whose coarsen() is its refinement parent and whose interpolation
        is the one refine() recorded): -pc_mg_levels of them, else
        coarsen until 10 levels, N <= 50, or a size that does not coarsen;
        each coarse level rediscretized by the DM's compute_operators
        callback (called with ksp None, as the reference does) where one is
        attached, else left to the Galerkin product; the interpolations
        from DMCreateInterpolation. The callbacks' host seconds are logged
        as the event PCMGSetUp_compute_operators."""
        from ..dm.da import DMDA
        from ..dm.plex import DMPlex
        if not isinstance(dm, (DMDA, DMPlex)):
            raise Error(f"PCMG: the operator's DM is a {type(dm).__name__}, not a DMDA or "
                        "a DMPlex; PCMG builds levels from those only (or give them with "
                        "setLevels and setInterpolation)")
        nlev_opt = self.pc.opt("get_int", "pc_mg_levels", None)
        das = [dm]
        while True:
            if nlev_opt is not None and len(das) >= nlev_opt:
                break
            if nlev_opt is None and (len(das) >= 10 or das[-1].N <= 50):
                break
            try:
                das.append(das[-1].coarsen())
            except Error:
                break
        self.levels = [MGLevelSpec(None) for _ in das]
        rediscretize = dm._compute_operators is not None
        for l, da in enumerate(das):
            if l > 0 and rediscretize:
                t0 = time.perf_counter()
                A = da.createMatrix()
                dm._compute_operators(None, A, A)
                if not A._assembled:
                    A.assemble()
                config.log().log_event("PCMGSetUp_compute_operators", time.perf_counter() - t0)
                self.levels[l].A = A
            if l < len(das) - 1:
                self.levels[l].P = da.createInterpolation(das[l + 1])

    def setup(self):
        self.build_hierarchy()
        return build_mg_meta_data(
            self.levels, cycle=self.cycle, smoother=self.smoother,
            pre=self.smooth_pre, post=self.smooth_post,
            coarse=self.coarse_solver, levels_pc=self.levels_pc,
            esteig_tform=self.esteig_tform, dtype=self.dtype)

    def view(self):
        if self.levels is None:
            return
        n = len(self.levels)
        print(f"    MG: type is MULTIPLICATIVE, levels={n} cycles={self.cycle}")
        for l, lev in enumerate(self.levels):
            m = lev.A.getSize()[0] if lev.A is not None else 0
            nnz = lev.A.nnz() if lev.A is not None else 0
            print(f"      level {n - 1 - l}: rows={m}, nnz={nnz}" +
                  (f", cheby eig [{lev.emin:.4g}, {lev.emax:.4g}]" if lev.emax else ""))


def _cast_f32(d):
    """A level's data with every float64 tensor in float32."""
    if isinstance(d, dict):
        return {k: _cast_f32(v) for k, v in d.items()}
    if isinstance(d, torch.Tensor) and d.dtype == torch.float64:
        return d.to(torch.float32)
    return d


def build_mg_meta_data(levels, cycle="v", smoother="chebyshev", pre=2, post=2,
                       coarse="lu", levels_pc="jacobi",
                       esteig_tform=(0.0, 0.1, 0.0, 1.1), dtype=None):
    """The hierarchy as the (meta, data) pair of the ``pc_mg`` binder.

    dtype="f32": every level's data is cast to float32 and the bound
    cycle converts at its boundary (-pc_mg_dtype single). The coarse LU
    factor is logged as the host event PCMGSetUp_LU."""
    from ..mat.aij import MatAIJ
    rd = config.real_dtype()
    dev = config.device()
    lev_metas, lev_datas = [], []
    nlev = len(levels)
    for l, lev in enumerate(levels):
        A = lev.A
        if l == nlev - 1:
            if coarse == "cg_jacobi":
                lev_metas.append(("coarse_cg", A.meta, A.getSize()[0]))
                lev_datas.append({"A": A.device_data(), "dinv": _inv_diag(_diag_vector(A)).to(rd)})
                continue
            # the coarsest: dense LU (the reference's coarse default, gamg.c:887-907)
            lu, piv = _timed("PCMGSetUp_LU", _dense_lu_factor, A.to_scipy())
            lev_metas.append(("coarse_lu", A.getSize()[0]))
            # scipy's pivots are 0-based row swaps, torch's (LAPACK's) 1-based
            lev_datas.append({"lu": torch.as_tensor(lu, dtype=rd, device=dev),
                              "piv": torch.as_tensor(piv + 1, dtype=torch.int32, device=dev)})
            if A.comm.size > 1:
                # a sharded coarsest level: every rank solves the gathered
                # right-hand side and keeps its block
                lev_datas[-1].update(comm=A.comm, layout=A.row_layout)
            continue
        P = lev.P
        R = lev.R
        # a Q1 transfer restricts by its own transpose (Q1R), and so does the
        # telescope step of a sharded hierarchy (gamg.MatRowBlockP)
        if R is None and P.meta[0] not in ("interp_q1", "interp_q1_mpi", "p_row_block"):
            R = MatAIJ.from_scipy(native.csr_transpose(P.to_scipy().tocsr()), comm=P.comm)
        pc_tab = None
        if levels_pc == "asm_agg" and lev.agg is not None:
            A_sp = A.to_scipy()
            dof_lists, inv = _timed("PCMGSetUp_agg_blocks", _agg_blocks_host, A_sp, lev.agg,
                                    lev.agg_bs)
            pc_tab = agg_block_tables(dof_lists, inv, dev, rd)
            # the bounds of M^-1 A for this PC, not D^-1 A (the esteig KSP
            # runs preconditioned, cheby.c; mg.py:366-390), through A1's
            # plain version on host copies of the tables
            n = A_sp.shape[0]
            host_tab = agg_block_tables(dof_lists, inv, "cpu", torch.float64)
            emn, emx = _timed(
                "PCMGSetUp_emax", _host_eig_bounds,
                lambda v: agg_block_apply_plain(host_tab, torch.from_numpy(A_sp @ v)).numpy(),
                np.ones(n), n)
            del host_tab
            a, b_, c, d_ = esteig_tform
            emin, emax = a * emn + b_ * emx, c * emn + d_ * emx
        else:
            emax = lev.emax if lev.emax is not None else 2.0
            emin = lev.emin if lev.emin is not None else 0.2
        if dtype == "f32":
            # the reference keeps the bounds in the level data, cast with it
            emin, emax = float(np.float32(emin)), float(np.float32(emax))
        lev_metas.append((A.meta, P.meta, None if R is None else R.meta, smoother, pre, post))
        ld = {"A": A.device_data(), "P": P.device_data(),
              "R": {} if R is None else R.device_data(), "eig": (emin, emax)}
        if pc_tab is None:
            ld["dinv"] = _inv_diag(_diag_vector(A)).to(rd)
        else:
            ld["agg"] = pc_tab
        lev_datas.append(ld)
    if dtype == "f32":
        lev_datas = [_cast_f32(ld) for ld in lev_datas]
    meta = ("pc_mg", cycle, nlev, tuple(lev_metas), dtype)
    return meta, {"levels": tuple(lev_datas)}


# ---------------------------------------------------------------------
# binder: the cycle as one function on the card's vectors
# ---------------------------------------------------------------------

def _smooth(kind, Aop, dinv, eig, b, x, its):
    """`its` smoothing steps, x updated in place: with Jacobi inside when
    `dinv` is the inverse diagonal, with the PC z = dinv(r) when it is a
    function (the aggregate-block smoother)."""
    if kind == "chebyshev":
        return cheby_smooth(Aop.mult, dinv, b, x, its, eig[0], eig[1])
    if kind in ("chebyshev4", "fourth"):
        return cheby_smooth4(Aop.mult, dinv, b, x, its, eig[1])
    if kind in ("opt_fourth", "chebyshev4opt"):
        return cheby_smooth4(Aop.mult, dinv, b, x, its, eig[1], optimized=True)
    if kind == "richardson":
        # x += M^-1 (b - A x): C1's first mode with c = beta = 1
        r, p = torch.empty_like(b), torch.empty_like(b)
        for _ in range(its):
            if callable(dinv):
                triad(b, Aop.mult(x), torch.full((), -1.0, dtype=b.dtype, device=b.device),
                      out=r)
                pc_step(dinv, "first_z", r, p, x, 1.0)
            else:
                cheby_update("first", r, p, x, Aop.mult(x), dinv, 1.0, b=b)
        return x
    raise Error(f"PCMG: unknown smoother {kind}")


class AggBlockPC:
    """The aggregate-block smoother on A1's tables: z = pc(r), and
    fused(mode, r, p, x, c, beta, a), a smoothing step's tail in one launch
    (:func:`..ops.block_kernels.agg_block_cheby`)."""

    def __init__(self, tab):
        self.tab = tab

    def __call__(self, r):
        return agg_block_apply(self.tab, r)

    def fused(self, mode, r, p, x, c, beta=1.0, a=0.0):
        return agg_block_cheby(self.tab, r, mode, p, x, c, beta, a)


def _bind_pc_mg(meta, data):
    """Cycle types (PCMGSetType/PCMGSetCycleType, mg.c): multiplicative V
    (default) and W cycles, KASKADE (coarse solve, prolongation and
    post-smoothing only) and FULL (nested solves from the coarsest level
    up, a V-cycle at each stage)."""
    _, cycle, nlev, lev_metas, dtype = meta
    levels = data["levels"]
    ncycles = 2 if cycle == "w" else 1
    last = levels[-1]
    ref = last["lu"] if "lu" in last else last["dinv"]
    one = torch.ones((), dtype=ref.dtype, device=ref.device)
    minus_one = -one

    def coarse_solve(b):
        cm, cd = lev_metas[-1], last
        if cm[0] == "coarse_cg":
            # every rank holds the replicated coarsest level: its sums stay local
            with reducing(None):
                return coarse_cg(cm, cd, b)
        if "comm" in cd:
            comm, lay = cd["comm"], cd["layout"]
            xg = torch.linalg.lu_solve(cd["lu"], cd["piv"],
                                       comm.allgather(b)[: lay.N, None])[:, 0]
            lo, hi = lay.range(comm.rank)
            x = torch.zeros_like(b)
            x[: hi - lo] = xg[lo:hi]
            return x
        return torch.linalg.lu_solve(cd["lu"], cd["piv"], b[:, None])[:, 0]

    def coarse_cg(cm, cd, b):
        # Jacobi CG until |<r, z>| <= 1e-10 |<r0, z0>| or 200 steps (the
        # reference's -mg_coarse_ksp_type cg -mg_coarse_pc_type jacobi),
        # one host read per step
        Aop, dinv = operator.bind(cm[1], cd["A"]), cd["dinv"]
        x, r = torch.zeros_like(b), b.clone()
        z = dinv * r
        p = z.clone()
        rz = dot2(z, r)[0]
        rz_h = float(rz)
        atol2, it = 1e-10 * abs(rz_h), 0
        while abs(rz_h) > atol2 and it < 200:
            Ap = Aop.mult(p)
            alpha = rz / dot2(Ap, p)[0]
            triad(x, p, alpha, out=x)
            triad(r, Ap, -alpha, out=r)
            z = dinv * r
            rz2 = dot2(z, r)[0]
            triad(z, p, rz2 / rz, out=p)
            rz, rz_h, it = rz2, float(rz2), it + 1
        return x

    def bind_level(l):
        A_meta, P_meta, R_meta, kind, pre, post = lev_metas[l]
        ld = levels[l]
        Pop = operator.bind(P_meta, ld["P"])
        restrict = Pop.mult_t if R_meta is None else operator.bind(R_meta, ld["R"]).mult
        if "agg" in ld:
            pc = AggBlockPC(ld["agg"])
        else:
            pc = ld["dinv"]
        return (operator.bind(A_meta, ld["A"]), Pop, restrict, pc, ld["eig"], kind, pre, post)

    bound = [bind_level(l) for l in range(nlev - 1)]

    def level_apply(l, b, x0=None):
        if l == nlev - 1:
            return coarse_solve(b)
        Aop, Pop, restrict, dinv, eig, kind, pre, post = bound[l]
        if cycle == "kaskade":
            x = Pop.mult(level_apply(l + 1, restrict(b)))
            return _smooth(kind, Aop, dinv, eig, b, x, post)
        x = _smooth(kind, Aop, dinv, eig, b, torch.zeros_like(b) if x0 is None else x0, pre)
        for c in range(ncycles):
            r = triad(b, Aop.mult(x), minus_one)              # b - A x
            xc = level_apply(l + 1, restrict(r))
            triad(x, Pop.mult(xc), one, out=x)                # x + P xc
            if c < ncycles - 1 or post:
                x = _smooth(kind, Aop, dinv, eig, b, x, post)
        return x

    def full_apply(b):
        # F-cycle: restrict b to the coarsest level, then work upward with
        # a V-cycle per level seeded by the prolongated coarser solution
        bs = [b]
        for l in range(nlev - 1):
            bs.append(bound[l][2](bs[-1]))
        x = coarse_solve(bs[-1])
        for l in range(nlev - 2, -1, -1):
            x = level_apply(l, bs[l], x0=bound[l][1].mult(x))
        return x

    inner = full_apply if cycle == "full" else (lambda b: level_apply(0, b))
    if dtype == "f32":
        # boundary casts: the f64 residual in, the f32 cycle, the f64 correction out
        base = inner
        inner = lambda b: base(b.to(torch.float32)).to(b.dtype)  # noqa: E731
    # with equal, symmetric pre- and post-smoothing the cycle is its own
    # transpose (PCApplyTranspose_MG)
    return operator.Op(mult=inner, mult_t=inner)


operator.register_binder("pc_mg", _bind_pc_mg)
PC.register_impl("mg", _PCMG)
