"""ExchangePlan: the communication backend (PetscSF), one process per rank.

Counterpart of ``petsc_tpu/parallel/sf.py`` (PetscSF, src/vec/is/sf/: a
star forest of leaves -> roots; PetscSFBcastBegin sf.c:1481 root -> leaf,
PetscSFReduceBegin leaf -> root with MPI_SUM; VecScatter, vscat.c:1294).

The host tables are built exactly as the reference builds them (every
rank runs the same set-up over the same leaves): per neighbour offset d
the reference's ``pack`` (sender rows) and ``unpack`` (receiver halo
positions), or the all-gather lowering when the offsets exceed
``max_neighbors`` or P <= 2. At run time the reference's per-offset
``ppermute`` becomes ONE ``all_to_all_single`` with per-rank split sizes
(:meth:`..parallel.mesh.Comm.alltoallv_start`), which both gloo and NCCL
take:

* ``bcast``: the pack is the K8 gather ``x[send_idx]`` (the entries every
  other rank reads from this one, grouped by destination rank), one
  exchange, and the unpack the X1 scatter of the received entries to
  their halo positions (one entry a position, so X1's sum is the value:
  the set of the reference's ``.at[].set``). No arithmetic: the halo
  equals the reference's in bits.
* ``reduce_add``: the reverse, each leaf's contribution sent to its root's
  owner and summed there by X1 (add mode) in the reference's order (the
  offsets d ascending, then the pack order), so in bits.
* the all-gather lowering: bcast gathers every rank's block (one
  all_gather) and picks its leaves with K8; reduce_add sums its leaves
  into a global buffer (X1), all-reduces it and keeps its block.

``gather``, ``fetch_and_add`` and ``compose`` are set-up operations, as in
the reference: a global table summed over the ranks (one all-reduce).
``VecScatter`` builds the cross-layout plan of vscat.c and applies it
through bcast.

``begin`` issues the exchange and returns; ``finish`` waits and unpacks,
so device work issued between them overlaps the exchange (MatMult_MPIAIJ's
order, mpiaij.c:1052-1065).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gather_kernels import gather
from ..ops.pc_kernels import dst_scatter, scatter_table
from .layout import Layout


class ExchangePlan:
    """The halo plan of one rank over a communicator."""

    def __init__(self, layout: Layout, leaves_per_shard, axis: str = "rows",
                 max_neighbors: int = 8, comm=None):
        """leaves_per_shard: list (len P) of int arrays of GLOBAL indices
        each rank reads (typically its compacted off-diagonal columns)."""
        P = layout.nshards
        blk = layout.block
        self.layout = layout
        self.axis = axis
        self.P = P
        self.comm = comm
        self.leaves_per_shard = [np.asarray(lv, dtype=np.int64) for lv in leaves_per_shard]
        self._glt = None
        self._dev = {}
        self.H = max((len(lv) for lv in leaves_per_shard), default=1) or 1
        # offsets d such that some shard s needs data from shard (s + d) % P
        need = {}
        for s, lv in enumerate(self.leaves_per_shard):
            owners = lv // blk
            for t in np.unique(owners):
                d = int((t - s) % P)
                need.setdefault(d, []).append(s)
        self.offsets = sorted(need)
        self.use_allgather = len(self.offsets) > max_neighbors or P <= 2
        if self.use_allgather:
            ga = np.zeros((P, self.H), dtype=np.int64)
            for s, lv in enumerate(self.leaves_per_shard):
                ga[s, : len(lv)] = lv
            self.gidx = ga
            return
        # per-offset pack (sender local rows) and unpack (receiver halo positions)
        self.pack, self.unpack, self.counts = {}, {}, {}
        for d in self.offsets:
            per_send, per_recv = [], []
            Hd = 0
            for j in range(P):
                s = (j - d) % P                  # receiver
                lv = self.leaves_per_shard[s]
                sel = np.nonzero(lv // blk == j)[0]
                per_send.append(lv[sel] - j * blk)
                per_recv.append(sel)
                Hd = max(Hd, len(sel))
            Hd = max(Hd, 1)
            pk = np.zeros((P, Hd), dtype=np.int64)
            up = np.full((P, Hd), self.H, dtype=np.int64)   # sentinel: dropped
            for j in range(P):
                pk[j, : len(per_send[j])] = per_send[j]
                up[(j - d) % P, : len(per_recv[j])] = per_recv[j]
            self.pack[d], self.unpack[d], self.counts[d] = pk, up, Hd

    def meta(self):
        """Hashable static descriptor, as the reference's."""
        if self.use_allgather:
            return ("sf_allgather", self.P, self.H)
        return ("sf_neighbor", self.P, self.H, tuple(self.offsets),
                tuple(self.counts[d] for d in self.offsets))

    # ---------------- this rank's exchange tables ----------------

    def rank_tables(self, r):
        """Rank r's side of the one exchange: (send_idx, send_counts,
        recv_pos, recv_counts, reduce entry order). send_idx are r's local
        rows that every rank t reads, grouped by t in rank order; recv_pos
        the halo positions of what r receives, grouped by source rank;
        `order` sorts the received entries of reduce_add by the reference's
        offsets d = (r - t) % P ascending."""
        blk, P = self.layout.block, self.P
        lv_r = self.leaves_per_shard[r]
        own_r = lv_r // blk
        send_idx, send_counts, recv_pos, recv_counts, dkey = [], [], [], [], []
        for t in range(P):
            lv_t = self.leaves_per_shard[t]
            mine = lv_t[lv_t // blk == r] - r * blk
            send_idx.append(mine)
            send_counts.append(len(mine))
            dkey.append(np.full(len(mine), (r - t) % P, dtype=np.int64))
            sel = np.nonzero(own_r == t)[0]
            recv_pos.append(sel)
            recv_counts.append(len(sel))
        send_idx = np.concatenate(send_idx) if send_idx else np.zeros(0, np.int64)
        dkey = np.concatenate(dkey) if dkey else np.zeros(0, np.int64)
        order = np.argsort(dkey, kind="stable")
        return (send_idx, np.asarray(send_counts), np.concatenate(recv_pos),
                np.asarray(recv_counts), order)

    def _tables(self, device):
        """This rank's device tables (built once per device)."""
        key = str(device)
        if key in self._dev:
            return self._dev[key]
        r, blk, H = self.comm.rank, self.layout.block, self.H
        if self.use_allgather:
            lv = self.leaves_per_shard[r]
            n = len(lv)
            tab = {"gidx": torch.as_tensor(lv.astype(np.int32), device=device),
                   # reduce_add: leaf k adds into global row lv[k]
                   "scat": scatter_table(lv, np.arange(n), self.P * blk, H, device=device),
                   "n": n}
        else:
            send_idx, scnt, rpos, rcnt, order = self.rank_tables(r)
            tab = {"send_idx": torch.as_tensor(send_idx.astype(np.int32), device=device),
                   "scnt": scnt, "rcnt": rcnt,
                   # bcast's unpack: received entry k lands at halo position rpos[k]
                   "unpack": scatter_table(rpos, np.arange(len(rpos)), H, max(len(rpos), 1),
                                           device=device),
                   # reduce_add's pack: the contributions at the halo positions
                   "rpos": torch.as_tensor(rpos.astype(np.int32), device=device),
                   # reduce_add's sum: received entry k adds into local row
                   # send_idx[k], in the reference's order
                   "reduce": scatter_table(send_idx[order], order, blk, max(len(order), 1),
                                           device=device)}
        self._dev[key] = tab
        return tab

    # ---------------- the run-time exchange ----------------

    def begin(self, x_local):
        """Issue bcast's exchange of this rank's block x_local (blk,)."""
        tab = self._tables(x_local.device)
        if self.use_allgather:
            return ("ag", tab, self.comm.allgather(x_local))
        buf = gather(x_local, tab["send_idx"], check=False) if len(tab["send_idx"]) \
            else x_local[:0]
        return ("nb", tab, self.comm.alltoallv_start(buf, tab["scnt"], tab["rcnt"]))

    def finish(self, handle):
        """The (H,) halo values of this rank's leaves (zero past them)."""
        kind, tab, h = handle
        if kind == "ag":
            vals = gather(h, tab["gidx"], check=False) if tab["n"] else h[:0]
            out = torch.zeros(self.H, dtype=h.dtype, device=h.device)
            out[: tab["n"]] = vals
            return out
        recv = h.wait()
        if recv.numel() == 0:
            return torch.zeros(self.H, dtype=recv.dtype, device=recv.device)
        return dst_scatter(tab["unpack"], recv)

    def bcast(self, x_local):
        """Root -> leaf (PetscSFBcast): this rank's (H,) halo."""
        return self.finish(self.begin(x_local))

    def reduce_add(self, leaf_vals):
        """Leaf -> root ADD (PetscSFReduce with MPIU_SUM): leaf_vals (H,)
        of this rank's leaves; returns its (blk,) root sums."""
        tab = self._tables(leaf_vals.device)
        blk = self.layout.block
        if self.use_allgather:
            g = dst_scatter(tab["scat"], leaf_vals) if tab["n"] else \
                torch.zeros(self.P * blk, dtype=leaf_vals.dtype, device=leaf_vals.device)
            self.comm.allreduce_(g)
            r = self.comm.rank
            return g[r * blk:(r + 1) * blk].clone()
        contrib = gather(leaf_vals, tab["rpos"], check=False) if len(tab["rpos"]) \
            else leaf_vals[:0]
        recv = self.comm.alltoallv(contrib, tab["rcnt"], tab["scnt"])
        if recv.numel() == 0:
            return torch.zeros(blk, dtype=leaf_vals.dtype, device=leaf_vals.device)
        return dst_scatter(tab["reduce"], recv)

    # ---- the set-up surface: gather / fetch-and-add / compose ----
    # (PetscSFGatherBegin, PetscSFFetchAndOpBegin, PetscSFCompose;
    # sf.py:164-285)

    def _global_leaf_tables(self):
        """(gidx (P,H), cnt (P,), slot (P,H), D): each leaf's slot among its
        root's leaves (shard-major order), D the largest root degree."""
        if self._glt is not None:
            return self._glt
        P, H = self.P, self.H
        ga = np.zeros((P, H), dtype=np.int64)
        cnt = np.zeros(P, dtype=np.int64)
        slot = np.zeros((P, H), dtype=np.int64)
        roots, where = [], []
        for s, lv in enumerate(self.leaves_per_shard):
            ga[s, : len(lv)] = lv
            cnt[s] = len(lv)
            roots.extend(lv.tolist())
            where.extend((s, p) for p in range(len(lv)))
        roots = np.asarray(roots, dtype=np.int64)
        order = np.argsort(roots, kind="stable")
        sr = roots[order]
        seq = np.arange(len(order)) - np.searchsorted(sr, sr)
        for k, o in enumerate(order):
            s, p = where[o]
            slot[s, p] = seq[k]
        D = int(seq.max()) + 1 if len(seq) else 1
        self._glt = (ga, cnt, slot, D)
        return self._glt

    def _contributions(self, leaf_vals):
        """The (P blk, D) table of every rank's leaf values at (root, slot),
        summed over the ranks (each slot has one leaf: the sum is exact)."""
        ga, cnt, slot, D = self._global_leaf_tables()
        r, blk = self.comm.rank, self.layout.block
        n = int(cnt[r])
        g = torch.zeros((self.P * blk, D), dtype=leaf_vals.dtype, device=leaf_vals.device)
        dev = leaf_vals.device
        g[torch.as_tensor(ga[r, :n], device=dev), torch.as_tensor(slot[r, :n], device=dev)] = \
            leaf_vals[:n]
        return self.comm.allreduce_(g)

    def gather(self, leaf_vals):
        """Root-side gather (PetscSFGather): this rank's (blk, D) table, row
        i holding root i's leaf values in slot order, zero past its degree.
        leaf_vals: this rank's (H,) leaf values."""
        r, blk = self.comm.rank, self.layout.block
        return self._contributions(leaf_vals)[r * blk:(r + 1) * blk].clone()

    def fetch_and_add(self, x_local, leaf_vals):
        """PetscSFFetchAndOp with MPIU_SUM in the deterministic slot order:
        each leaf receives its root's value before its own update (the
        root's start value plus the lower slots' contributions); roots take
        the full sum. Returns (fetched (H,), updated roots (blk,))."""
        ga, cnt, slot, D = self._global_leaf_tables()
        r, blk = self.comm.rank, self.layout.block
        g = self._contributions(leaf_vals)
        xg = self.comm.allgather(x_local)
        excl = torch.cumsum(g, dim=1) - g
        dev = leaf_vals.device
        gi = torch.as_tensor(ga[r], device=dev)
        fetched = xg[gi] + excl[gi, torch.as_tensor(slot[r], device=dev)]
        upd = x_local + torch.sum(g, dim=1)[r * blk:(r + 1) * blk]
        return fetched, upd

    def compose(self, other: "ExchangePlan"):
        """SFCompose: other's leaves index positions in this plan's per-rank
        leaf arrays; the result's leaves are the roots those resolve to."""
        new_leaves = []
        for s in range(self.P):
            mine = self.leaves_per_shard[s]
            idx = other.leaves_per_shard[s]
            new_leaves.append(mine[idx] if len(mine) else idx[:0])
        return ExchangePlan(self.layout, new_leaves, axis=self.axis, comm=self.comm)


class VecScatter:
    """y[iy] = x[ix] across layouts (vscat.c). On a multi-rank comm the
    scatter is compiled on the host to a cross-layout ExchangePlan keyed by
    the destination layout: each y-rank's leaves are the x indices it reads,
    moved by the plan and written into the rank's block (sf.py:288-363).
    One rank: a gather on the device."""

    def __init__(self, x_layout, ix, y_layout, iy, comm=None):
        self.ix = np.asarray(ix, dtype=np.int64)
        self.iy = np.asarray(iy, dtype=np.int64)
        self.x_layout = x_layout
        self.y_layout = y_layout
        self.comm = comm
        self.plan = None
        P = y_layout.nshards
        if comm is not None and P > 1 and x_layout.nshards == P:
            blk_y = y_layout.block
            owners = self.iy // blk_y
            leaves, ypos = [], []
            for s in range(P):
                sel = owners == s
                leaves.append(self.ix[sel])
                ypos.append(self.iy[sel] - s * blk_y)
            self.plan = ExchangePlan(x_layout, leaves, axis=comm.axis, comm=comm)
            H = self.plan.H
            yp = np.full((P, H), blk_y, dtype=np.int64)     # sentinel: dropped
            for s in range(P):
                yp[s, : len(ypos[s])] = ypos[s]
            self._ypos = yp

    def _dist_apply(self, x, y, addv):
        halo = self.plan.bcast(x.array)
        r = self.comm.rank
        n = len(self.plan.leaves_per_shard[r])
        pos = torch.as_tensor(self._ypos[r, :n], device=halo.device)
        a = y.array.clone()
        if addv:
            a.index_put_((pos,), halo[:n], accumulate=True)
        else:
            a[pos] = halo[:n]
        y.array = a
        return y

    def apply(self, x, y, addv=False):
        if self.plan is not None:
            return self._dist_apply(x, y, addv)
        dev = x.array.device
        vals = x.array[torch.as_tensor(self.ix, device=dev)]
        a = y.array.clone()
        a.index_put_((torch.as_tensor(self.iy, device=dev),), vals, accumulate=bool(addv))
        y.array = a
        return y

    begin = apply

    def end(self, *a, **kw):
        return None
