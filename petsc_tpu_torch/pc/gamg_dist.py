"""Distributed smoothed-aggregation set-up on per-rank row blocks.

Counterpart of ``petsc_tpu/pc/gamg_dist.py``, host numpy as in the
reference and run the same on every rank (so the aggregates and the
hierarchy equal the reference's by construction): the strength graph and
its symmetrisation (agg.c:752 with MatTranspose_MPIAIJ), MIS aggregation
in hashed-priority rounds (mis.c:89, Luby style: a vertex roots when its
priority beats every undecided neighbour's, then root neighbours are
captured), the square-graph aggressive coarsening with the direct
neighbour fix-up (agg.c:913), the tentative prolongator with cross-rank
aggregate norms (formProl0 agg.c:592, one near-null vector), the
prolongator smoothing P <- (I - 1.4/emax D^-1 A) P0 (agg.c:1811) and the
scalable PtAP (mpiptap.c:215) through ShardedCSR.ptap.

Coarse vertices live in the padded coarse space: rank s's aggregates get
ids s * blockC + local; the per-rank raggedness becomes in-block gaps,
which take identity rows where a level is collapsed to the replicated
serial tail (gamg.c:155-201).
"""

from __future__ import annotations

import numpy as np

from ..mat.shardcsr import ShardedCSR
from ..parallel.layout import Layout


def _hash_weights(lo, hi, seed=2026):
    """Index-stable pseudo-random priorities in [0,1) for global ids."""
    idx = np.arange(lo, hi, dtype=np.uint64)
    h = (idx * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return (h % np.uint64(1 << 52)).astype(np.float64) / float(1 << 52)


def _row_reduce_max(vals, indptr, empty=-np.inf):
    """Per-row max of CSR-aligned values."""
    out = np.full(len(indptr) - 1, empty)
    nonempty = np.diff(indptr) > 0
    if vals.size:
        red = np.maximum.reduceat(vals, indptr[:-1][nonempty])
        out[nonempty] = red
    return out


def dist_strength_graph(A: ShardedCSR, threshold=-1.0):
    """Symmetrized strength graph |A| + |A|^T with threshold filtering
    (PCGAMGCreateGraph_AGG agg.c:752), per shard. bs=1 (nodal == dof)."""
    import scipy.sparse as sp
    absA = ShardedCSR([abs(b) for b in A.blocks], A.row_layout,
                      A.col_layout)
    At = absA.transpose()
    G = absA.add(ShardedCSR(At.blocks, A.row_layout, A.col_layout))
    if threshold >= 0:
        # |g_ij| > threshold * sqrt(g_ii g_jj); diagonal never dropped
        dshards = G.diag_shards()
        dglob = np.zeros(G.col_layout.Npad)
        blk = G.row_layout.block
        for s, d in enumerate(dshards):
            dglob[s * blk:s * blk + len(d)] = np.sqrt(np.abs(d))
        dglob[dglob == 0] = 1.0
        blocks = []
        for s, b in enumerate(G.blocks):
            rows = np.repeat(np.arange(b.shape[0]), np.diff(b.indptr))
            gi = rows + s * blk
            keep = (np.abs(b.data) > threshold * dglob[gi]
                    * dglob[b.indices]) | (b.indices == gi)
            bi = np.zeros(b.shape[0] + 1, dtype=np.int64)
            np.add.at(bi, rows[keep] + 1, 1)
            blocks.append(sp.csr_matrix(
                (b.data[keep], b.indices[keep], np.cumsum(bi)),
                shape=b.shape))
        G = ShardedCSR(blocks, G.row_layout, G.col_layout)
    return G


def _square_graph(G: ShardedCSR):
    """Boolean G^2 (distance-2 adjacency) per shard."""
    import scipy.sparse as sp
    Gb = ShardedCSR(
        [sp.csr_matrix((np.ones_like(b.data), b.indices, b.indptr),
                       shape=b.shape) for b in G.blocks],
        G.row_layout, G.col_layout)
    G2 = Gb.spmm(Gb)
    for b in G2.blocks:
        b.data[:] = 1.0
    return G2


# vertex states
UNDECIDED, ROOT, TAKEN, REMOVED = 0, 1, 2, 3


def dist_mis_aggregate(G: ShardedCSR, seed=2026, max_rounds=200):
    """Boundary-aware MIS aggregation in randomized rounds.

    Returns (agg_root (Npad,) global fine id of each vertex's aggregate
    root or -1, state (Npad,)). Structure: each round every shard decides
    locally from its rows + freshly fetched ghost states/priorities; ghost
    refresh is the halo exchange of mis.c's multi-rank protocol."""
    rl = G.row_layout
    P, blk = rl.nshards, rl.block
    Npad = rl.Npad
    w = _hash_weights(0, Npad, seed)
    state = np.full(Npad, UNDECIDED, dtype=np.int8)
    agg_root = np.full(Npad, -1, dtype=np.int64)
    # pad rows and singletons (only-diagonal rows) are removed (mis.c:117)
    for s, b in enumerate(G.blocks):
        gi0 = s * blk
        rl_len = np.diff(b.indptr)
        lo, hi = rl.range(s)
        nreal = hi - lo
        state[gi0 + nreal: gi0 + blk] = REMOVED
        singles = np.nonzero(rl_len[:nreal] < 2)[0]
        state[gi0 + singles] = REMOVED

    for _ in range(max_rounds):
        undecided_total = int((state == UNDECIDED).sum())
        if undecided_total == 0:
            break
        # phase 1: root selection (priority beats all undecided neighbors)
        new_roots = []
        for s, b in enumerate(G.blocks):
            gi0 = s * blk
            gids = np.arange(gi0, gi0 + blk)
            mine_und = state[gids] == UNDECIDED
            if not mine_und.any():
                new_roots.append(np.zeros(0, dtype=np.int64))
                continue
            nb_w = np.where((state[b.indices] == UNDECIDED)
                            & (b.indices != np.repeat(gids,
                                                      np.diff(b.indptr))),
                            w[b.indices] + 1e-18 * b.indices, -np.inf)
            row_max = _row_reduce_max(nb_w, b.indptr)
            pri = w[gids] + 1e-18 * gids
            wins = mine_und & (pri > row_max)
            new_roots.append(gids[wins])
        for roots in new_roots:
            state[roots] = ROOT
            agg_root[roots] = roots
        # phase 2: capture undecided neighbors of roots (strongest root
        # neighbor wins, deterministic by priority)
        for s, b in enumerate(G.blocks):
            gi0 = s * blk
            gids = np.arange(gi0, gi0 + blk)
            mine_und = state[gids] == UNDECIDED
            if not mine_und.any():
                continue
            is_root_nb = state[b.indices] == ROOT
            nb_w = np.where(is_root_nb, w[b.indices] + 1e-18 * b.indices,
                            -np.inf)
            row_max = _row_reduce_max(nb_w, b.indptr)
            # recover argmax root id per row
            take = mine_und & np.isfinite(row_max)
            if not take.any():
                continue
            # find, per taken row, the neighbor achieving the max
            rows = np.repeat(np.arange(blk), np.diff(b.indptr))
            cand = np.nonzero(is_root_nb
                              & (nb_w == row_max[rows]))[0]
            # first hit per row wins (values are unique by construction)
            rsel = rows[cand]
            first = np.ones(len(cand), dtype=bool)
            first[1:] = rsel[1:] != rsel[:-1]
            cand = cand[first]
            rsel = rsel[first]
            sel = take[rsel]
            state[gi0 + rsel[sel]] = TAKEN
            agg_root[gi0 + rsel[sel]] = b.indices[cand[sel]]
    # leftovers (no undecided neighbors but never rooted): make roots
    left = state == UNDECIDED
    state[left] = ROOT
    agg_root[left] = np.nonzero(left)[0]
    return agg_root, state


def dist_fix_aggregates(G1: ShardedCSR, agg_root, state):
    """Post-MIS(G^2) fixup (agg.c:913): every root steals its DIRECT
    G1-neighbors (non-roots) into its own aggregate; larger root gid wins
    on conflicts (the deterministic analog of lid-order last-wins)."""
    rl = G1.row_layout
    blk = rl.block
    claim = np.full(rl.Npad, -1, dtype=np.int64)
    for s, b in enumerate(G1.blocks):
        gi0 = s * blk
        gids = np.arange(gi0, gi0 + blk)
        roots = state[gids] == ROOT
        if not roots.any():
            continue
        rows = np.repeat(gids, np.diff(b.indptr))
        sel = roots[rows - gi0] & (state[b.indices] != ROOT)
        np.maximum.at(claim, b.indices[sel], rows[sel])
    stolen = claim >= 0
    agg_root[stolen] = claim[stolen]
    state[stolen] = TAKEN
    return agg_root, state


def coarse_numbering(agg_root, state, rl: Layout, pad_to=8):
    """Coarse ids in padded coarse space: shard s's roots (sorted by gid)
    get ids s*blockC + k. Returns (cid (Npad,) coarse id per fine vertex
    or -1, coarse Layout, nagg_per_shard)."""
    blk = rl.block
    P = rl.nshards
    root_gids = [np.nonzero(state[s * blk:(s + 1) * blk] == ROOT)[0]
                 + s * blk for s in range(P)]
    nagg = np.array([len(r) for r in root_gids])
    blockC = max(int(-(-max(nagg.max(), 1) // pad_to)) * pad_to, pad_to)
    cl = Layout(int(blockC * P), nshards=P)
    root_to_cid = np.full(rl.Npad, -1, dtype=np.int64)
    for s in range(P):
        root_to_cid[root_gids[s]] = s * blockC + np.arange(len(root_gids[s]))
    cid = np.where(agg_root >= 0, root_to_cid[np.maximum(agg_root, 0)], -1)
    return cid, cl, nagg


def dist_tentative_prolongator(cid, bvec, rl: Layout, cl: Layout):
    """P0 and coarse near-nullspace for nvec=1 (formProl0 agg.c:592, the
    scalar QR: q = b/||b||_agg, r = ||b||_agg). Cross-shard aggregate
    norms accumulate by owner (the reduce of remote members)."""
    import scipy.sparse as sp
    blk = rl.block
    # aggregate-wise sum of squares (owner-keyed reduction)
    norm2 = np.zeros(cl.Npad)
    np.add.at(norm2, np.maximum(cid, 0),
              np.where(cid >= 0, bvec * bvec, 0.0))
    norms = np.sqrt(norm2)
    norms_safe = np.where(norms == 0, 1.0, norms)
    blocks = []
    for s in range(rl.nshards):
        gids = np.arange(s * blk, (s + 1) * blk)
        sel = cid[gids] >= 0
        rows = np.nonzero(sel)[0]
        cols = cid[gids[sel]]
        vals = bvec[gids[sel]] / norms_safe[cols]
        blocks.append(sp.csr_matrix((vals, (rows, cols)),
                                    shape=(blk, cl.Npad)))
    Bc = norms  # coarse near-nullspace (padded coarse space)
    return ShardedCSR(blocks, rl, cl), Bc


def dist_emax(A: ShardedCSR, dinv_glob, iters=8, seed=7):
    """Largest Ritz value of D^-1 A via Arnoldi on the per-shard matvec
    (the esteig role, no global matrix)."""
    n = A.row_layout.Npad
    rng = np.random.default_rng(seed)
    m = min(iters, n)
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    v = rng.random(n) - 0.5
    v[~A.row_layout.valid_mask_np] = 0.0
    V[0] = v / np.linalg.norm(v)
    for j in range(m):
        w = dinv_glob * A.matvec(V[j])
        for i in range(j + 1):
            H[i, j] = V[i] @ w
            w -= H[i, j] * V[i]
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] < 1e-14:
            m = j + 1
            break
        V[j + 1] = w / H[j + 1, j]
    ritz = np.linalg.eigvals(H[:m, :m])
    return max(float(np.max(np.abs(ritz))), 1e-12)


def build_level(A: ShardedCSR, bvec, threshold=-1.0, aggressive=False,
                nsmooths=1, seed=2026):
    """One SA level: returns (P sharded, Ac sharded, Bc coarse vec, emax,
    nagg_total)."""
    G = dist_strength_graph(A, threshold)
    if aggressive:
        G2 = _square_graph(G)
        agg_root, state = dist_mis_aggregate(G2, seed)
        agg_root, state = dist_fix_aggregates(G, agg_root, state)
    else:
        agg_root, state = dist_mis_aggregate(G, seed)
    cid, cl, nagg = coarse_numbering(agg_root, state, A.row_layout)
    P0, Bc = dist_tentative_prolongator(cid, bvec, A.row_layout, cl)
    dshards = A.diag_shards()
    blk = A.row_layout.block
    dinv = np.zeros(A.row_layout.Npad)
    for s, d in enumerate(dshards):
        dd = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        dinv[s * blk:s * blk + len(d)] = dd
    emax = dist_emax(A, dinv)
    Pm = P0
    for _ in range(nsmooths):
        W = A.spmm(Pm)
        dinv_shards = [dinv[s * blk:(s + 1) * blk] for s in range(A.nshards)]
        Pm = Pm.add(W.scale_rows([(-1.4 / emax) * dv
                                  for dv in dinv_shards]))
    Ac = A.ptap(Pm).prune()
    return Pm, Ac, Bc, emax, int(nagg.sum())
