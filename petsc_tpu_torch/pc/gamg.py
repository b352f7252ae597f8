"""PCGAMG: smoothed-aggregation algebraic multigrid, with the structured head.

Counterpart of ``petsc_tpu/pc/gamg.py`` (reference src/ksp/pc/impls/gamg/
gamg.c, PCSetUp_GAMG :538 level loop, coarse_eq_limit 50, Chebyshev with
Jacobi smoothers and the SA eigenvalue reuse :934-941; agg.c, the strength
graph :752, MIS aggregation through mat/graphops/coarsen/impls/mis/mis.c
in a random visit order, the squared-graph coarsening of the first level
:1311, the tentative prolongator by per-aggregate QR of the near-nullspace
:592, prolongator smoothing P <- (I - 1.4/emax D^-1 A) P0 :1912-1922).

An operator that declares a grid (a stencil Mat from
``stencil_build.as_mat``, or a MatAIJ after ``setStencilGrid``) first
takes the reference's structured head (gamg.py:460-535, a TPU redesign
with no gamg.c equivalent): geometric levels with the Q1 interpolation
(:mod:`..dm.interp`) down to ``-pc_gamg_structured_limit`` rows. The
device head (:mod:`.gamg_device`) computes their Galerkin operators on
the card by stencil probing and their Chebyshev bounds by Lanczos, and
brings only the small tail to the host; with
``-pc_gamg_structured_device 0`` the host head forms them by the native
SpGEMM instead. ``-pc_gamg_structured_coarsening 0`` turns the head off.

The aggregation then runs on the host in numpy/scipy and the port's
native kernels (:mod:`petsc_tpu_torch.native`), once per operator, as in
the reference: the strength graph, the aggregation, the QR, the
prolongator smoothing and the Galerkin products. The cycle runs on the
card through the shared PCMG binder (:mod:`.mg`): the grid levels on S1
and V1 with Q1P and Q1R for their transfers, the aggregation levels'
A, P and R = P^T on the CSR kernel S2, the smoothing on the fused
Chebyshev update C1.

The aggregation takes block systems (bs > 1: the strength graph collapses
each bs x bs block to one node, optionally over the components of
``-pc_gamg_mat_coarsen_strength_index``), a near-nullspace of several
vectors (the rigid-body modes of elasticity: the tentative prolongator's
QR per aggregate, then nvec dofs per coarse node), and PCHMG on a block
system (the inner GAMG on one component, its P expanded as P kron I_bs).
A block level's P is an assembled MatAIJ on S2, the coarse operators bs 1
on S2, as in the reference. ``-pc_gamg_type classical`` (Ruge-Stüben:
classical strength, MIS coarse points, direct or standard interpolation by
``-pc_gamg_classical_type``, ``-pc_gamg_classical_nsmooths`` Jacobi
smoothings) and ``geo`` (linearly exact interpolation from
PCSetCoordinates) build their levels on the host (:mod:`.gamg_classical`),
as the reference does; the cycle is the same.

On a multi-rank operator (:mod:`..parallel.mesh`, one process per rank;
host set-up the same on every rank) the hierarchy keeps its first levels
sharded (gamg.py:405-575): a ``dnd_mpi`` grid stencil takes the sharded
structured head (``_structured_head_mpi``: probed ``dnd_mpi`` levels with
the slab Q1 transfer while the slab contract holds), an ``mpiaij``
operator the distributed aggregation (``_dist_levels``, :mod:`.gamg_dist`
on per-rank blocks, its levels bound by ``MatAIJ.from_sharded``). Once the
problem is small, it is collapsed once to a replicated host CSR that every
rank holds (the telescope pattern, gamg.c:155-201), and the serial
aggregation continues on it; the last sharded level's interpolation
becomes a :class:`MatRowBlockP` (the rank's rows of P; its transpose sums
the ranks' partials), the cycle's one step between sharded and replicated
vectors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config, native
from ..dm.interp import MatInterpQ1, MatInterpQ1MPI
from ..mat.aij import MatAIJ
from ..ops import stencil_build
from . import gamg_device as gd
from ..ops import operator
from ..ops.pallas_kernels import csr_spmv
from ..parallel.mesh import comm_self
from ..sys.error import Error
from .mg import MGLevelSpec, _PCMG, _host_emax, _timed
from .pc import PC


# ---------------------------------------------------------------------
# host-side setup pieces
# ---------------------------------------------------------------------

def strength_graph(A_sp, bs=1, threshold=-1.0, index=None):
    """Nodal strength-of-connection graph (agg.c:752 PCGAMGCreateGraph_AGG):
    |A| + |A|^T, entries with |g_ij| <= threshold * sqrt(|g_ii g_jj|)
    dropped (threshold < 0 keeps everything, the diagonal always stays).
    A scalar graph with no strength index comes from the native kernel;
    otherwise scipy forms it as the reference does (gamg.py:31-70): |A|
    restricted to the components in `index` (-pc_gamg_mat_coarsen_strength_index),
    for bs > 1 collapsed to nodes as C^T |A| C with C the block indicator,
    then symmetrised and filtered."""
    import scipy.sparse as sp
    if bs == 1 and index is None:
        return native.strength_sym(A_sp.tocsr(), threshold)
    n_dof = A_sp.shape[0]
    G = abs(A_sp).tocsr()
    if bs > 1:
        if index is not None:
            sel = np.isin(np.arange(n_dof) % bs, np.asarray(index)).astype(np.float64)
            G = (sp.diags(sel) @ G @ sp.diags(sel)).tocsr()
        C = sp.csr_matrix((np.ones(n_dof), (np.arange(n_dof), np.arange(n_dof) // bs)),
                          shape=(n_dof, n_dof // bs))
        G = (C.T @ G @ C).tocsr()
    G = (G + G.T).tocsr()
    if threshold >= 0:
        d = np.sqrt(np.abs(G.diagonal()))
        d[d == 0] = 1.0
        rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
        keep = (np.abs(G.data) > threshold * d[rows] * d[G.indices]) | (G.indices == rows)
        G = sp.csr_matrix((G.data[keep], G.indices[keep],
                           np.concatenate([[0], np.cumsum(np.bincount(rows[keep],
                                                                      minlength=G.shape[0]))])),
                          shape=G.shape)
    return G


def _visit_order(n):
    """The reference's visit order: a random permutation from a fixed seed
    (PCGAMGCoarsen_AGG agg.c:1279-1303 shuffles; gamg.py:85, :152)."""
    return np.random.default_rng(2026).permutation(n)


def mis_aggregate(G, perm=None):
    """Greedy MIS aggregation (mis.c:89-207, strict_aggs serial semantics):
    visit vertices in `perm` order; an undecided vertex becomes an aggregate
    root and captures its undecided neighbours; isolated vertices (only a
    diagonal entry) are removed (no aggregate, a zero row in P).

    Returns (agg, nagg, roots): the aggregate of each vertex (-1 for
    removed), their number and their roots."""
    perm = _visit_order(G.shape[0]) if perm is None else perm
    return native.mis_aggregate(G.indptr, G.indices, perm)


def fix_aggregates_with_square(G1, agg, roots):
    """Post-MIS(G^2) fixup (agg.c:913 fixAggregatesWithSquare): every root
    takes its direct (unsquared-graph) non-root neighbours into its own
    aggregate, in root order (later roots win)."""
    return native.fix_aggregates(G1.indptr, G1.indices, roots, agg)


def square_graph(G):
    """The boolean G^2 (distance-2 adjacency, PCGAMGSquareGraph_GAMG). The
    set-up never forms it (:func:`mis_aggregate_squared`); it is the
    definition that function is held to."""
    B = G.copy()
    B.data = np.ones_like(B.data)
    G2 = (B @ B).tocsr()
    G2.data = np.ones_like(G2.data)
    return G2


def mis_aggregate_squared(G, perm=None):
    """MIS aggregation on the implicit squared graph: the greedy semantics
    of ``mis_aggregate(square_graph(G), perm)`` without forming G^2."""
    perm = _visit_order(G.shape[0]) if perm is None else perm
    return native.mis2_aggregate(G.indptr, G.indices, perm)


def _spgemm(A, B):
    """C = A @ B by the native Gustavson kernel."""
    return native.spgemm(A.tocsr(), B.tocsr())


def _galerkin(cur, P):
    """Ac = P^T cur P (the MatPtAP numeric phase, mpiptap.c:215 role): the
    native transpose and two SpGEMMs."""
    Pc = P.tocsr()
    Ac = _spgemm(native.csr_transpose(Pc), _spgemm(cur, Pc))
    Ac.eliminate_zeros()
    return Ac


def _smooth_prol(cur, P, dinv, omega):
    """P <- (I - omega D^-1 cur) P (agg.c:1811 numeric): the native SpGEMM,
    the row scaling on the CSR data."""
    W = _spgemm(cur, P)
    W.data *= np.repeat(-omega * dinv, np.diff(W.indptr))
    out = (P + W).tocsr()
    out.sort_indices()
    return out


def tentative_prolongator(agg, nagg, Bn, bs=1):
    """P0 and the coarse near-nullspace by per-aggregate QR (formProl0
    agg.c:592: LAPACK geqrf/orgqr per aggregate; here batched by aggregate
    size). Bn: (n_fine_dofs, nvec) near-nullspace. agg is NODAL (length
    n/bs); each node carries bs dofs."""
    import scipy.sparse as sp
    nnode = len(agg)
    nf = nnode * bs
    nvec = Bn.shape[1]
    nc = nagg * nvec
    rows_l, cols_l, vals_l = [], [], []
    Bc = np.zeros((nc, nvec))
    order = np.argsort(agg, kind="stable")
    order = order[agg[order] >= 0]
    bounds = np.searchsorted(agg[order], np.arange(nagg + 1))
    sizes = np.diff(bounds)
    for sz in np.unique(sizes):
        which = np.nonzero(sizes == sz)[0]
        # (len(which), sz) node ids per aggregate of this size
        nodes = order[bounds[which][:, None] + np.arange(sz)[None, :]]
        dofs = (nodes[:, :, None] * bs + np.arange(bs)[None, None, :]) \
            .reshape(len(which), sz * bs)
        blocks = Bn[dofs]                       # (na, sz*bs, nvec)
        if sz * bs < nvec:                      # undersized aggregate: pad
            blocks = np.concatenate(
                [blocks, np.zeros((len(which), nvec - sz * bs, nvec))], axis=1)
        q, r = np.linalg.qr(blocks)             # batched thin QR
        q = q[:, :sz * bs, :]
        # sign fix: R's diagonal positive (deterministic, LAPACK-like)
        sgn = np.sign(np.einsum("aii->ai", r))
        sgn[sgn == 0] = 1.0
        q = q * sgn[:, None, :]
        r = r * sgn[:, :, None]
        ii = np.broadcast_to(dofs[:, :, None], q.shape)
        jj = (which[:, None, None] * nvec
              + np.broadcast_to(np.arange(nvec)[None, None, :], q.shape))
        rows_l.append(ii.ravel())
        cols_l.append(jj.ravel())
        vals_l.append(q.ravel())
        Bc[(which[:, None] * nvec + np.arange(nvec)[None, :]).ravel()] = r.reshape(-1, nvec)
    P0 = sp.csr_matrix((np.concatenate(vals_l),
                        (np.concatenate(rows_l), np.concatenate(cols_l))),
                       shape=(nf, nc))
    P0.eliminate_zeros()
    return P0, Bc


class MatSmoothedProl:
    """The smoothed prolongator P = (I - omega D^-1 A) P0 of a scalar level,
    applied ASSEMBLED on the CSR kernel S2 (kind ``aij_csr``).

    The reference keeps P factored (``_bind_prol_sa``: P0 x_c = w x_c[agg]
    followed by the level operator's product) because the TPU has no
    hardware gather. Hopper has one, and on it the factored form costs
    more: each apply would run a product with the fine operator (27
    entries per row) where the assembled P has about 4 (on the 128^3
    box27, 0.26 ms against 0.10 ms, both by chip_smoke.py on an NVIDIA
    H100 80GB HBM3 at 700 W), and its transpose would be a segment sum,
    in torch an ``index_add_`` with atomics whose sums change from run
    to run. Restriction is S2 on the explicit R = P^T
    that the PCMG set-up forms. The two forms are the same matrix, so
    results agree to rounding.

    The constructor keeps the reference's signature: A_level, agg, w, dinv
    and omega are the factors, P_scipy their product, the one the card
    applies. ``to_scipy`` returns it for the host Galerkin product."""

    def __init__(self, A_level, agg, w, dinv, omega, P_scipy, comm):
        self.comm = comm
        self._P_scipy = P_scipy
        self._P = MatAIJ.from_scipy(P_scipy, comm=comm)

    @property
    def meta(self):
        return self._P.meta

    def device_data(self):
        return self._P.device_data()

    def getSize(self):
        return self._P_scipy.shape

    def to_scipy(self):
        return self._P_scipy

    def transpose(self):
        return MatAIJ.from_scipy(self._P_scipy.T.tocsr(), comm=self.comm)


class MatRowBlockP:
    """The interpolation from a replicated coarse level onto a sharded fine
    level: each rank holds its rows of the host P (padded to its block) on
    S2. mult takes the replicated coarse vector and gives the rank's fine
    block; mult_t gives the rank's partial of P^T r (S2 on the explicit
    local transpose) summed over the ranks, the replicated coarse vector
    (the reference's GSPMD reshard at the telescope boundary)."""

    def __init__(self, P_scipy, row_layout, comm):
        import scipy.sparse as sp
        self.comm = comm
        self._P_scipy = P_scipy.tocsr()
        lo, hi = row_layout.range(comm.rank)
        Pl = self._P_scipy[lo:hi]
        if hi - lo < row_layout.block:
            Pl = sp.vstack([Pl, sp.csr_matrix((row_layout.block - (hi - lo), Pl.shape[1]))])
        self._local = MatAIJ.from_scipy(Pl.tocsr())
        self._local_t = MatAIJ.from_scipy(native.csr_transpose(Pl.tocsr()))

    @property
    def meta(self):
        return ("p_row_block", self._local.meta, self._local_t.meta)

    def device_data(self):
        return {"P": self._local.device_data(), "R": self._local_t.device_data(),
                "comm": self.comm}

    def getSize(self):
        return self._P_scipy.shape

    def to_scipy(self):
        return self._P_scipy


def _bind_p_row_block(meta, data):
    _, pm, rm = meta
    P, R, comm = data["P"], data["R"], data["comm"]
    return operator.Op(
        mult=lambda xc: csr_spmv(P["indptr"], P["col"], P["vals"], xc),
        mult_t=lambda r: comm.allreduce_(csr_spmv(R["indptr"], R["col"], R["vals"], r)))


operator.register_binder("p_row_block", _bind_p_row_block)


def _inv_diag_host(A_sp):
    d = A_sp.diagonal()
    return np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)


def _hem_graph(cur, threshold, index=None, bs=1):
    """The graph HEM matches on (MatCreateGraph with scale=TRUE,
    mpiaij.c:8070): D^-1/2 (|A| + |A|^T) D^-1/2 of the nodal graph, so the
    diagonal is 1, with entries <= the ABSOLUTE threshold dropped
    (MatFilter) and the diagonal kept."""
    import scipy.sparse as sp
    G = strength_graph(cur, bs=bs, threshold=-1.0, index=index).tocsr().copy()
    dg = G.diagonal()
    s = np.where(dg != 0, 1.0 / np.sqrt(np.abs(np.where(dg == 0, 1.0, dg))), 1.0)
    rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
    G.data = G.data * s[rows] * s[G.indices]
    keep = (np.abs(G.data) > threshold) | (G.indices == rows)
    if not keep.all():
        G = sp.csr_matrix(
            (G.data[keep], G.indices[keep],
             np.concatenate([[0], np.cumsum(np.bincount(rows[keep], minlength=G.shape[0]))])),
            shape=G.shape)
    return G


class _PCGAMG(_PCMG):
    """Smoothed-aggregation AMG set-up driving the shared MG machinery."""

    def __init__(self, pc):
        super().__init__(pc)
        self.coarse_eq_limit = 50
        self.max_levels = 10
        self.threshold = [-1.0]
        self.nsmooths = 1
        self.aggressive_levels = 1
        self.coarsen_type = "mis"      # mis | hem
        self.hem_rounds = 3
        self.strength_index = None
        self.gamg_type = "agg"         # agg | classical | geo
        self.classical_type = "direct"  # direct | standard
        self.classical_nsmooths = 0
        # the structured head (gamg.py:346-352): operators that declare a
        # grid get geometric first levels down to structured_limit rows,
        # their Galerkin operators probed on the device
        self.structured = True
        self.structured_limit = 3000
        self.structured_device = True

    def set_from_options(self):
        super().set_from_options()
        o = self.pc.opt
        n = o("get_int", "pc_gamg_coarse_eq_limit", None)
        if n:
            self.coarse_eq_limit = n
        n = o("get_int", "pc_gamg_aggressive_coarsening", None)
        if n is not None:
            self.aggressive_levels = n
        n = o("get_int", "pc_gamg_agg_nsmooths", None)
        if n is not None:
            self.nsmooths = n
        t = o("get_string", "pc_gamg_threshold", None)
        if t:
            self.threshold = [float(x) for x in t.split(",")]
        n = o("get_int", "pc_mg_levels", None)
        if n:
            self.max_levels = n
        t = o("get_string", "pc_gamg_mat_coarsen_type", None)
        if t:
            self.coarsen_type = t
        n = o("get_int", "pc_gamg_mat_coarsen_max_it", None)
        if n:
            self.hem_rounds = n
        t = o("get_string", "pc_gamg_mat_coarsen_strength_index", None)
        if t:
            self.strength_index = [int(x) for x in t.split(",")]
        t = o("get_string", "pc_gamg_type", None)
        if t:
            self.gamg_type = t
        t = o("get_string", "pc_gamg_classical_type", None)
        if t:
            self.classical_type = t
        n = o("get_int", "pc_gamg_classical_nsmooths", None)
        if n is not None:
            self.classical_nsmooths = n
        b = o("get_bool", "pc_gamg_structured_coarsening", None)
        if b is not None:
            self.structured = b
        n = o("get_int", "pc_gamg_structured_limit", None)
        if n:
            self.structured_limit = n
        b = o("get_bool", "pc_gamg_structured_device", None)
        if b is not None:
            self.structured_device = b

    def _threshold(self, level):
        if level < len(self.threshold):
            return self.threshold[level]
        return self.threshold[-1]

    def _near_nullspace(self, A):
        """The near-nullspace as an (N, nvec) array: the constant vector
        unless the operator carries one, given as an array, an object with
        `.vectors`, or a MatNullSpace (read through ``dense_or``, so the
        rigid-body modes of ``createRigidBody`` arrive: the reference reads
        their empty `.vectors` and fails, ROADMAP section 3)."""
        N = A.getSize()[0]
        Bn = getattr(A, "near_nullspace", None)
        if Bn is None:
            return np.ones((N, 1))
        if hasattr(Bn, "dense_or"):
            Bn = Bn.dense_or(N)
        return np.asarray(getattr(Bn, "vectors", Bn), dtype=np.float64).reshape(N, -1)

    def _classical_level(self, cur, level, levels):
        """One Ruge-Stüben level (the reference's gamg.py:660-703): classical
        strength, MIS coarse points, the direct, standard or geometric P,
        classical_nsmooths Jacobi smoothings. Returns the coarse operator, or
        None where coarsening stalls."""
        from .gamg_classical import (classical_direct_prolongator, classical_standard_prolongator,
                                     classical_strength, geometric_prolongator)
        from ..sys.error import Error
        if self.gamg_type == "geo" and level == 0:
            self._geo_coords = getattr(self.pc, "_coords", None)
            if self._geo_coords is None:
                raise Error("gamg geo needs PCSetCoordinates (PCGAMGGeo contract, geo.c)")
        theta = max(self._threshold(level), 0.0)
        G = _timed("PCGAMGSetUp_graph", classical_strength, cur, theta)
        agg, nagg, roots = _timed("PCGAMGSetUp_coarsen", mis_aggregate, G)
        if nagg == 0 or len(roots) >= cur.shape[0]:
            return None
        if self.gamg_type == "geo":
            P = _timed("PCGAMGSetUp_prol0", geometric_prolongator, cur, roots,
                       self._geo_coords, theta)
            self._geo_coords = self._geo_coords[roots]
        else:
            mk = (classical_standard_prolongator if self.classical_type == "standard"
                  else classical_direct_prolongator)
            P = _timed("PCGAMGSetUp_prol0", mk, cur, roots, theta)
        dinv = _inv_diag_host(cur)
        emax = _timed("PCGAMGSetUp_emax", _host_emax, cur, dinv)
        for _ in range(self.classical_nsmooths):
            P = _timed("PCGAMGSetUp_smooth_prol", _smooth_prol, cur, P, dinv, 1.4 / emax)
        levels[-1].emin, levels[-1].emax = self.eig_bounds(emax)
        levels[-1].agg = np.asarray(agg)
        levels[-1].agg_bs = 1
        levels[-1].P = MatAIJ.from_scipy(P, comm=self.pc.pmat.comm)
        Ac = _timed("PCGAMGSetUp_SpGEMM", _galerkin, cur, P)
        levels.append(MGLevelSpec(MatAIJ.from_scipy(Ac, comm=self.pc.pmat.comm)))
        return Ac

    def _coarsen(self, cur, level, bs=1):
        """The aggregates of one level's nodes (bs dofs each): (agg, nagg)."""
        thr = self._threshold(level)
        if self.coarsen_type == "hem":
            # exact serial HEM (hem.c) on the scaled, filtered graph
            thr = max(thr, 0.0)
            G = _timed("PCGAMGSetUp_graph", _hem_graph, cur, thr, self.strength_index, bs)
            return _timed("PCGAMGSetUp_coarsen", native.hem_match, G.indptr, G.indices,
                          G.data, self.hem_rounds, thr)
        G = _timed("PCGAMGSetUp_graph", strength_graph, cur, bs, thr, self.strength_index)
        if level < self.aggressive_levels:
            # MIS on the square, then every root takes its direct neighbours
            agg, nagg, roots = _timed("PCGAMGSetUp_coarsen", mis_aggregate_squared, G)
            agg = _timed("PCGAMGSetUp_coarsen", fix_aggregates_with_square, G, agg, roots)
        else:
            agg, nagg, _ = _timed("PCGAMGSetUp_coarsen", mis_aggregate, G)
        return agg, nagg

    def _structured_head(self, A_sp, shape, levels, level):
        """Geometric first levels on the host (gamg.py:460-493): the Q1
        interpolation, the Galerkin product by the native SpGEMM, the host
        Arnoldi bound, each coarse operator a MatAIJ on its grid (the dnd
        layout, V1). Returns (the tail's host CSR, the level reached)."""
        cur, cur_shape = A_sp.tocsr(), tuple(shape)
        limit = max(self.coarse_eq_limit, self.structured_limit)
        while (int(np.prod(cur_shape)) > limit and min(cur_shape) >= 4
               and level < self.max_levels - 1):
            cshape = tuple((s + 1) // 2 for s in cur_shape)
            Pm = MatInterpQ1(cur_shape, cshape)
            Ac = _timed("PCGAMGSetUp_SpGEMM", _galerkin, cur, Pm.to_scipy())
            emax = _timed("PCGAMGSetUp_emax", _host_emax, cur, _inv_diag_host(cur))
            levels[-1].emin, levels[-1].emax = self.eig_bounds(emax)
            levels[-1].P = Pm
            levels.append(MGLevelSpec(MatAIJ.from_scipy(Ac, grid=cshape)))
            cur, cur_shape = Ac, cshape
            level += 1
        return cur, level

    def _structured_head_device(self, Afine, levels):
        """Geometric first levels on the device (gamg.py:495-535): the
        Galerkin operators by stencil probing, the bounds by Lanczos, all
        levels' recurrences fetched in one transfer; the tail comes to the
        host once as CSR. Under -pc_mg_dtype single the head is probed,
        bounded and stored in float32. Host seconds: the events
        PCGAMGSetUp_head (the probes and the Lanczos, which the fetch waits
        for) and PCGAMGSetUp_tail_download. Returns (the tail's host CSR,
        the level reached)."""
        meta, data = Afine.meta, Afine.device_data()
        cur_shape = tuple(int(s) for s in meta[1])
        level = len(levels) - 1
        limit = max(self.coarse_eq_limit, self.structured_limit)
        hd = torch.float32 if self.dtype == "f32" else None
        t0 = time.perf_counter()
        pend = []
        while (int(np.prod(cur_shape)) > limit and min(cur_shape) >= 4
               and level < self.max_levels - 1):
            cshape = tuple((s + 1) // 2 for s in cur_shape)
            pend.append((levels[-1], gd.lanczos_futures(meta, data, dtype=hd)))
            levels[-1].P = MatInterpQ1(cur_shape, cshape)
            meta, data = gd.device_rap_dnd(meta, data, cshape, dtype=hd)
            levels.append(MGLevelSpec(stencil_build.as_mat(meta, data)))
            cur_shape = cshape
            level += 1
        emaxes = gd.emax_batch([ab for _, ab in pend])
        config.log().log_event("PCGAMGSetUp_head", time.perf_counter() - t0)
        for (lev, _), emax in zip(pend, emaxes):
            lev.emin, lev.emax = self.eig_bounds(emax)
        return _timed("PCGAMGSetUp_tail_download", stencil_build.dnd_to_csr, meta, data), level

    def build_hierarchy(self):
        """The reference's hierarchy (gamg.py:597-787): the device
        structured head on a grid stencil, else the host head on a MatAIJ
        that declares a grid, then the serial aggregation loop on the host
        CSR of what is left; on a multi-rank operator the sharded head or
        the distributed aggregation first (_build_dist). Host seconds are
        logged as the events PCGAMGSetUp_head and _tail_download (the device
        head), PCGAMGSetUp_download (the fine values from the card), _native
        (the build of graphops.cpp, where this is its first use), _graph,
        _coarsen, _prol0, _emax, _smooth_prol and _SpGEMM (the Galerkin
        products)."""
        A = self.pc.pmat
        Bn = self._near_nullspace(A)
        bs = A.row_layout.bs or 1
        _timed("PCGAMGSetUp_native", native.lib)
        # level 0 uses the Pmat; only a host_only Pmat (the numerically
        # identical twin of the Amat) lets the device Amat stand in
        Afine = self.pc.mat if getattr(A, "host_only", False) and self.pc.mat is not None \
            else A
        levels = [MGLevelSpec(Afine)]
        level = 0
        # the structured head is scalar: bs 1 and one near-null vector
        scalar = bs == 1 and Bn.shape[1] == 1 and self.gamg_type == "agg"
        if A.comm.nshards > 1:
            self.levels = self._build_dist(A, Afine, levels, scalar)
            return
        fm = Afine.meta
        if (scalar and self.structured and self.structured_device
                and gd.supports_device_rap(fm) and int(np.prod(fm[1])) == A.getSize()[0]):
            # the device head first: the fine operator never comes to the host
            cur, level = self._structured_head_device(Afine, levels)
        else:
            sync = getattr(A, "_sync_host_vals", None)
            if sync is not None:
                # values that setValuesCOO left on the card come to the host once
                _timed("PCGAMGSetUp_download", sync)
            cur = A.to_scipy()
            shape = getattr(A, "_grid_shape", None) or getattr(Afine, "_grid_shape", None)
            if (scalar and self.structured and shape is not None and len(shape) >= 2
                    and int(np.prod(shape)) == cur.shape[0]):
                cur, level = self._structured_head(cur, shape, levels, level)
        if level > 0:
            Bn = np.ones((cur.shape[0], 1))
        self._aggregate(cur, Bn, bs, level, levels, A.comm)
        self.levels = levels

    def _aggregate(self, cur, Bn, bs, level, levels, comm):
        """The serial aggregation loop on the host CSR `cur` from `level` on
        (gamg.py:704-787), each new level's P and A on `comm`."""
        cur_bs = bs
        while cur.shape[0] > self.coarse_eq_limit and level < self.max_levels - 1:
            if self.gamg_type in ("classical", "geo"):
                Ac = self._classical_level(cur, level, levels)
                if Ac is None:
                    break
                cur = Ac
                level += 1
                continue
            agg, nagg = self._coarsen(cur, level, cur_bs)
            if nagg == 0 or nagg * Bn.shape[1] >= cur.shape[0]:
                break  # coarsening stalled
            # the aggregates stay on the level they coarsen: they define the
            # -pc_gamg_asm_use_agg smoother blocks
            levels[-1].agg = np.asarray(agg)
            levels[-1].agg_bs = cur_bs
            P0, Bc = _timed("PCGAMGSetUp_prol0", tentative_prolongator, agg, nagg, Bn, cur_bs)
            dinv = _inv_diag_host(cur)
            emax = _timed("PCGAMGSetUp_emax", _host_emax, cur, dinv)
            P = P0
            for _ in range(self.nsmooths):
                P = _timed("PCGAMGSetUp_smooth_prol", _smooth_prol, cur, P, dinv, 1.4 / emax)
            # SA eigenvalue reuse for the level smoother (gamg.c:934)
            levels[-1].emin, levels[-1].emax = self.eig_bounds(emax)
            Ac = _timed("PCGAMGSetUp_SpGEMM", _galerkin, cur, P)
            if self.nsmooths <= 1 and Bn.shape[1] == 1 and cur_bs == 1:
                nf = P0.shape[0]
                w = np.zeros(nf)
                w[np.repeat(np.arange(nf), np.diff(P0.indptr))] = P0.data
                omega = (1.4 / emax) if self.nsmooths == 1 else 0.0
                levels[-1].P = MatSmoothedProl(levels[-1].A, agg, w, dinv, omega, P, comm)
            else:
                levels[-1].P = MatAIJ.from_scipy(P, comm=comm)
            levels.append(MGLevelSpec(MatAIJ.from_scipy(Ac, comm=comm)))
            cur, Bn = Ac, Bc
            # the coarse problem has nvec dofs per aggregate (its operator stays bs 1)
            cur_bs = Bc.shape[1]
            level += 1

    # ---------------- the sharded first levels ----------------

    def _build_dist(self, A, Afine, levels, scalar):
        """The hierarchy of a multi-rank operator (gamg.py:611-633): the
        sharded structured head on a dnd_mpi stencil, else the distributed
        aggregation on an mpiaij operator; then the serial aggregation on
        the replicated tail, and the telescope step at the last sharded
        level."""
        from ..sys.info import warn_full_gather
        if (scalar and self.structured
                and gd.supports_device_rap(Afine.meta, kinds=("dnd_mpi",))):
            cur, level = self._structured_head_mpi(Afine, levels)
            Bn = np.ones((cur.shape[0], 1))
        elif scalar and self.coarsen_type == "mis":
            cur, Bn, level = self._dist_levels(A, levels)
        else:
            warn_full_gather(A, "PCGAMG(serial setup on sharded operator: "
                                "bs>1/nullspace/non-MIS)")
            raise Error("PCGAMG on a sharded operator takes a scalar operator (bs 1, one "
                        "near-null vector), smoothed aggregation and MIS coarsening; "
                        f"this one has bs {A.row_layout.bs}, type {self.gamg_type}, "
                        f"coarsening {self.coarsen_type}")
        self._aggregate(cur, Bn, 1, level, levels, comm_self())
        # the telescope step: the P onto the last sharded level from the
        # first replicated one
        k = max(i for i, lev in enumerate(levels) if lev.A.comm.size > 1)
        if k < len(levels) - 1:
            levels[k].P = MatRowBlockP(levels[k].P.to_scipy(), levels[k].A.row_layout, A.comm)
        return levels

    def _dist_levels(self, A, levels):
        """Distributed aggregation (gamg.py:405-440): every phase on per-rank
        row blocks (gamg_dist), each level bound by from_sharded, until the
        problem is small; then one collapse to the replicated tail, whose
        gap rows (the padded coarse numbering's) become identity rows.
        Returns (tail CSR, tail near-nullspace, level reached)."""
        import scipy.sparse as sp
        from .gamg_dist import build_level
        S = A.shardcsr()
        bvec = S.row_layout.valid_mask_np.astype(np.float64)
        Bn = getattr(A, "near_nullspace", None)
        if Bn is not None:
            v = self._near_nullspace(A)
            bvec = np.zeros(S.row_layout.Npad)
            bvec[:A.row_layout.N] = v.reshape(-1)[:A.row_layout.N]
        collapse = max(self.coarse_eq_limit,
                       self.pc.opt("get_int", "pc_gamg_dist_coarse_limit", None) or 2000)
        nreal = A.row_layout.N
        cur, level = S, 0
        while nreal > collapse and level < self.max_levels - 1:
            aggressive = level < self.aggressive_levels
            P, Ac, Bc, emax, nagg = _timed("PCGAMGSetUp_dist_level", build_level, cur, bvec,
                                           self._threshold(level), aggressive, self.nsmooths)
            if nagg == 0 or nagg >= nreal:
                break
            levels[-1].emin, levels[-1].emax = self.eig_bounds(emax)
            levels[-1].P = MatAIJ.from_sharded(P, A.comm)
            levels.append(MGLevelSpec(MatAIJ.from_sharded(Ac, A.comm)))
            cur, bvec, nreal = Ac, Bc, nagg
            level += 1
        Ag = cur.to_global_csr().tocsr()
        n = Ag.shape[0]
        if Ag.shape[1] != n:
            Ag = sp.csr_matrix(Ag[:, :n])
        gaps = np.diff(Ag.indptr) == 0
        if gaps.any():
            Ag = (Ag + sp.diags(gaps.astype(np.float64))).tocsr()
        if level > 0:
            levels[-1].A = MatAIJ.from_scipy(Ag, comm=comm_self())
        return Ag, bvec.reshape(-1, 1), level

    def _structured_head_mpi(self, Afine, levels):
        """The sharded geometric first levels (gamg.py:537-575): the same
        probing as the device head on the dnd_mpi operator, the slab Q1
        transfers, Lanczos bounds summed over the ranks; coarsening stops
        where the slab contract or the structured limit breaks, and the tail
        is gathered once as host CSR. Host seconds: PCGAMGSetUp_head and
        _tail_download. Returns (tail CSR, level reached)."""
        meta, data = Afine.meta, Afine.device_data()
        cur_shape = tuple(int(s) for s in meta[3])
        Pn = int(meta[1])
        comm = Afine.comm
        level = len(levels) - 1
        limit = max(self.coarse_eq_limit, self.structured_limit)
        hd = torch.float32 if self.dtype == "f32" else None
        t0 = time.perf_counter()
        while (int(np.prod(cur_shape)) > limit and min(cur_shape) >= 4
               and level < self.max_levels - 1):
            cshape = tuple((s + 1) // 2 for s in cur_shape)
            # the slab contract: the coarse planes divide over the ranks
            if cshape[0] % Pn or cur_shape[0] != 2 * cshape[0]:
                break
            emax = gd.device_emax(meta, data, dtype=hd)
            levels[-1].emin, levels[-1].emax = self.eig_bounds(emax)
            levels[-1].P = MatInterpQ1MPI(cur_shape, cshape, comm)
            meta, data = gd.device_rap_dnd_mpi(meta, data, cshape, comm, dtype=hd)
            levels.append(MGLevelSpec(gd.as_mat_mpi(meta, data, comm)))
            cur_shape = cshape
            level += 1
        config.log().log_event("PCGAMGSetUp_head", time.perf_counter() - t0)
        return _timed("PCGAMGSetUp_tail_download", gd.mpi_to_csr, meta, data), level


class _PCHMG(_PCGAMG):
    """PCHMG (hmg/hmg.c): hybrid multigrid, the coarsening of one field
    component reused for an interlaced block system (gamg.py:790-849). On a
    scalar operator it is plain GAMG. On a block system the inner GAMG runs
    on the component's submatrix (-pc_hmg_component, default 0), each of
    its prolongators is expanded blockwise as P kron I_bs, and the levels
    are the Galerkin products of the full operator through them, each
    level's Chebyshev bounds [0.1, 1.1] times its host Arnoldi estimate."""

    def __init__(self, pc):
        super().__init__(pc)
        self.component = 0

    def set_from_options(self):
        super().set_from_options()
        c = self.pc.opt("get_int", "pc_hmg_component", None)
        if c is not None:
            self.component = c

    def build_hierarchy(self):
        import scipy.sparse as sp
        A = self.pc.pmat
        bs = A.row_layout.bs or 1
        if bs <= 1:
            return super().build_hierarchy()
        S = A.to_scipy().tocsr()
        comp = np.arange(self.component, S.shape[0], bs)
        A0 = MatAIJ.from_scipy(S[comp][:, comp].tocsr(), comm=A.comm)
        inner = PC(options=self.pc._options,
                   prefix=(self.pc.get_options_prefix() or "") + "hmg_inner_")
        inner.setOperators(A0, A0)
        inner.setType("gamg")
        inner.setFromOptions()
        inner._impl.build_hierarchy()
        levels = [MGLevelSpec(A)]
        cur = S
        for sl in inner._impl.levels[:-1]:
            P = sp.kron(sl.P.to_scipy(), sp.eye(bs), format="csr")
            emax = _timed("PCGAMGSetUp_emax", _host_emax, cur, _inv_diag_host(cur))
            levels[-1].emax, levels[-1].emin = 1.1 * emax, 0.1 * emax
            Ac = _timed("PCGAMGSetUp_SpGEMM", _galerkin, cur, P)
            levels[-1].P = MatAIJ.from_scipy(P, comm=A.comm)
            levels.append(MGLevelSpec(MatAIJ.from_scipy(Ac, comm=A.comm)))
            cur = Ac
        self.levels = levels


PC.register_impl("gamg", _PCGAMG)
PC.register_impl("hmg", _PCHMG)
