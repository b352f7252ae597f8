"""PCSOR, PCASM, PCComposite, PCKSP and PCFieldSplit.

Counterpart of ``petsc_tpu/pc/more_pc.py`` on one device.

SOR (sor.c): with
L' = w D^-1 L and U' = w D^-1 U the SSOR preconditioner
w (2 - w) (D + w U)^-1 D (D + w L)^-1 reduces to two unit triangular
solves, (D + w L)^-1 x = (I + L')^-1 (D^-1 x) and
(D + w U)^-1 (D y) = (I + U')^-1 y, each a level-scheduled sweep of
:mod:`petsc_tpu_torch.ops.trisolve` (kernel T1 on the card). The factors
keep the real dtype, as the reference's do.

ASM (asm.c): the reference's domains (contiguous near-equal row blocks,
``-pc_asm_blocks``, default 2 on one device, extended by
``-pc_asm_overlap`` rounds of pattern adjacency) and its one ILU(0) of the
block-diagonal matrix over the concatenated domains; the apply is the
gather ``x[gather]`` (K8), the two sweeps (T1) and the scatter of the owned
rows (``restrict``, X1's set mode) or of every domain row (``basic``, X1's
add mode, where domains overlap). Composite (composite.c): the sums and
``x - A y`` on K2 and the operator's product. PCKSP (pcksp.c): the inner
KSP's loop with the ``ksp_`` prefix. FieldSplit (fieldsplit.c): the fields'
gathers on K8, the scatter of each field's result on X1's set mode, the
off-diagonal blocks as ``MatAIJ`` (S2) and their subtractions on K2.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..mat import factor
from ..ops import operator, pc_kernels, trisolve
from ..ops.gather_kernels import gather
from ..ops.pallas_kernels import triad
from ..sys.error import Error
from .pc import PC


class _PCSOR:
    """SSOR by default; ``-pc_sor_forward`` / ``-pc_sor_backward`` take one
    sweep, ``-pc_sor_omega`` sets w."""

    def __init__(self, pc):
        self.pc = pc
        self.omega = 1.0
        self.sweep = "symmetric"   # symmetric | forward | backward

    def set_from_options(self):
        o = self.pc.opt
        w = o("get_real", "pc_sor_omega", None)
        if w:
            self.omega = w
        if o("get_bool", "pc_sor_forward", False):
            self.sweep = "forward"
        if o("get_bool", "pc_sor_backward", False):
            self.sweep = "backward"

    def setup(self):
        A = self.pc.pmat
        indptr, indices, vals = A.getValuesCSR()
        m = A.row_layout.N
        w = self.omega
        rows = np.repeat(np.arange(m), np.diff(indptr))
        d = np.zeros(m)
        np.add.at(d, rows[indices == rows], vals[indices == rows])
        d = np.where(d == 0, 1.0, d)
        lo = indices < rows
        up = indices > rows
        scale_rows = w / d
        rd, dev = config.real_dtype(), config.device()
        data = {
            "L": trisolve.make_sweep(_recount(rows[lo], m), indices[lo],
                                     vals[lo] * scale_rows[rows[lo]], lower=True, dtype=rd),
            "U": trisolve.make_sweep(_recount(rows[up], m), indices[up],
                                     vals[up] * scale_rows[rows[up]], lower=False, dtype=rd),
            "dinv": torch.as_tensor(1.0 / d, dtype=rd, device=dev),
            "winv": torch.as_tensor(w / d, dtype=rd, device=dev),
        }
        return ("pc_sor", m, data["L"].nlev, data["U"].nlev, A.row_layout.Npad, self.sweep,
                float(w * (2.0 - w))), data


def _recount(rows, m):
    cnt = np.zeros(m + 1, dtype=np.int64)
    np.add.at(cnt, rows + 1, 1)
    return np.cumsum(cnt)


def _bind_pc_sor(meta, data):
    sweep, sc = meta[5], meta[6]

    def mult(x):
        if sweep == "forward":
            return trisolve.unit_lower_solve(data["L"], data["winv"] * x)
        if sweep == "backward":
            return trisolve.unit_upper_solve(data["U"], data["winv"] * x)
        y = trisolve.unit_lower_solve(data["L"], data["dinv"] * x)
        return sc * trisolve.unit_upper_solve(data["U"], y)

    return operator.Op(mult=mult)


def _one(x, v=1.0):
    return torch.full((), v, dtype=x.dtype, device=x.device)


def add_vec(y, z):
    """y + z on K2."""
    return triad(y, z, _one(y))


def sub_vec(y, z):
    """y - z on K2."""
    return triad(y, z, _one(y, -1.0))


# ---------------------------------------------------------------------
# PCASM
# ---------------------------------------------------------------------

def grow_domain(S, dom, rounds):
    """dom extended by `rounds` rounds of S's pattern adjacency (the union
    with every column of its rows), as a sorted array (MatIncreaseOverlap)."""
    dom = np.asarray(dom, dtype=np.int64)
    for _ in range(rounds):
        if not len(dom):
            break
        dom = np.union1d(dom, np.unique(S[dom].indices))
    return dom


def domain_block_diag(S, doms):
    """The block-diagonal CSR of S restricted to each domain in turn (the
    reference's sp.block_diag([S[d][:, d] for d in doms])), built at once:
    each local row's entries whose column lies in its own domain, at the
    column's place there. Canonical (sorted columns); explicit zeros kept."""
    import scipy.sparse as sp
    S = S.tocsr()
    m = S.shape[0]
    lens = np.asarray([len(d) for d in doms], dtype=np.int64)
    flat = np.concatenate(doms).astype(np.int64) if len(doms) else np.zeros(0, np.int64)
    owner = np.repeat(np.arange(len(doms)), lens)
    off = np.concatenate([[0], np.cumsum(lens)])
    keys = owner * m + flat
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    cnt = np.diff(S.indptr)[flat]
    rloc = np.repeat(np.arange(len(flat)), cnt)
    ent = np.repeat(S.indptr[flat] - (np.cumsum(cnt) - cnt), cnt) + np.arange(len(rloc))
    col, val = S.indices[ent], S.data[ent]
    want = owner[rloc] * m + col
    # the last of equal keys, as the reference's {global: local} dict keeps
    last = np.searchsorted(skeys, want, side="right") - 1
    hit = (last >= 0) & (skeys[np.maximum(last, 0)] == want) if len(skeys) else last >= 0
    lcol = order[np.maximum(last, 0)]
    B = sp.coo_matrix((val[hit], (rloc[hit], lcol[hit])), shape=(len(flat), len(flat))).tocsr()
    B.sort_indices()
    return B, off


class _PCASM:
    """Overlapping block ILU(0) (the reference's restricted additive
    Schwarz): domains are contiguous row ranges extended by ``overlap``
    rounds of pattern adjacency; the apply gathers each domain, solves, and
    scatters the owned rows (``restrict``) or every domain row (``basic``)."""

    def __init__(self, pc):
        self.pc = pc
        self.nblocks = None
        self.overlap = 1
        self.asm_type = "restrict"

    def set_from_options(self):
        o = self.pc.opt
        n = o("get_int", "pc_asm_blocks", None)
        if n:
            self.nblocks = n
        v = o("get_int", "pc_asm_overlap", None)
        if v is not None:
            self.overlap = v
        t = o("get_string", "pc_asm_type", None)
        if t:
            self.asm_type = t

    def _default_domains(self, S, m):
        nb = self.nblocks or max(getattr(self.pc.pmat.comm, "nshards", 1), 2)
        sizes = np.full(nb, m // nb)
        sizes[: m % nb] += 1
        starts = np.concatenate([[0], np.cumsum(sizes)])
        return [(np.arange(starts[b], starts[b + 1]),
                 grow_domain(S, np.arange(starts[b], starts[b + 1]), self.overlap))
                for b in range(nb)]

    def domains(self):
        from ..sys.info import warn_full_gather
        warn_full_gather(self.pc.pmat, "PCASM(nblocks != nshards)")
        S = self.pc.pmat.to_scipy().tocsr()
        return S, self._default_domains(S, S.shape[0])

    def setup(self):
        A = self.pc.pmat
        nsh = A.comm.nshards
        if nsh > 1 and self.nblocks in (None, nsh) and hasattr(A, "shardcsr") \
                and self._kind == "pc_asm":
            return self._setup_dist(A)
        m = A.row_layout.N
        S, doms = self.domains()
        big, off = domain_block_diag(S, [d for _, d in doms])
        L, U, dinv = factor.ilu0(big.indptr.astype(np.int64), big.indices.astype(np.int64),
                                 big.data)
        dev, rd = config.device(), config.real_dtype()
        tail, data = trisolve.make_trisolve_plan(L, U, dinv)
        srcs, dsts = [], []
        for b, (own, dom) in enumerate(doms):
            if self.asm_type == "restrict":
                g2l = np.zeros(m, dtype=np.int64)
                g2l[dom] = np.arange(len(dom))
                srcs.append(off[b] + g2l[own])
                dsts.append(own)
            else:
                srcs.append(off[b] + np.arange(len(dom)))
                dsts.append(dom)
        src, dst = np.concatenate(srcs), np.concatenate(dsts)
        gat = np.concatenate([d for _, d in doms])
        w = self._weights(gat, m)
        data["gather"] = torch.as_tensor(gat.astype(np.int32), device=dev)
        data["scatter"] = pc_kernels.scatter_table(dst, src, m, len(gat),
                                                   None if w is None else w[dst], device=dev,
                                                   dtype=rd)
        if w is not None:
            # (w x)[gather] as X1's weighted gather
            data["wgather"] = pc_kernels.scatter_table(np.arange(len(gat)), gat, len(gat), m,
                                                       w[gat], device=dev, dtype=rd)
        data["set"] = self.asm_type == "restrict"
        return (self._kind,) + tail + (A.row_layout.Npad,), data

    _kind = "pc_asm"

    def _setup_dist(self, A):
        """Distributed restricted ASM (more_pc.py:207-277): one subdomain a
        rank, its rows grown by `overlap` rounds of pattern adjacency with
        the overlap rows fetched by owner (ShardedCSR.fetch_rows); the ghost
        values come by ExchangePlan.bcast, the domain's ILU(0) is swept by T1
        on the rank, the owned part kept (restrict) and for basic the
        overlap part sent back by reduce_add."""
        from ..parallel.sf import ExchangePlan
        S = A.shardcsr()
        rl, comm = S.row_layout, A.comm
        blk, nsh, r = rl.block, rl.nshards, comm.rank
        doms, ghosts = [], []
        for s in range(nsh):
            lo, hi = rl.range(s)
            dom = np.arange(lo, hi)
            for _ in range(self.overlap):
                cols = np.unique(S.fetch_rows(dom).indices)
                dom = np.union1d(dom, cols[cols < rl.N])
            doms.append(dom)
            ghosts.append(dom[(dom < lo) | (dom >= hi)])
        plan = ExchangePlan(rl, ghosts, axis=comm.axis, comm=comm)
        lo, hi = rl.range(r)
        dom, gh = doms[r], ghosts[r]
        sub = S.fetch_rows(dom)[:, dom].tocsr()
        L, U, dinv = factor.ilu0(sub.indptr.astype(np.int64), sub.indices.astype(np.int64),
                                 sub.data)
        tail, data = trisolve.make_trisolve_plan(L, U, dinv)
        # the domain's right-hand side from [x_local | halo]
        own = (dom >= lo) & (dom < hi)
        gi = np.empty(len(dom), dtype=np.int64)
        gi[own] = dom[own] - lo
        gi[~own] = blk + np.searchsorted(gh, dom[~own])
        dev, rd = config.device(), config.real_dtype()
        data["gidx"] = torch.as_tensor(gi.astype(np.int32), device=dev)
        data["own_pos"] = torch.as_tensor(np.searchsorted(dom, np.arange(lo, hi))
                                          .astype(np.int32), device=dev)
        data["ghost_pos"] = torch.as_tensor(np.searchsorted(dom, gh).astype(np.int32),
                                            device=dev)
        data["sf"] = plan
        return ("pc_asm_dist", blk, hi - lo, plan.H, self.asm_type), data

    def _weights(self, gat, m):
        """Weights on both sides of the domain solves (none for ASM)."""
        return None


def _bind_pc_asm_dist(meta, data):
    _, blk, nown, H, asm_type = meta
    plan = data["sf"]

    def mult(x):
        buf = torch.cat([x, plan.bcast(x)])
        sol = trisolve.trisolve_apply(data, gather(buf, data["gidx"], check=False))
        y = torch.zeros_like(x)
        y[:nown] = gather(sol, data["own_pos"], check=False)
        if asm_type == "basic":
            contrib = torch.zeros(H, dtype=x.dtype, device=x.device)
            ng = data["ghost_pos"].numel()
            contrib[:ng] = gather(sol, data["ghost_pos"], check=False)
            back = plan.reduce_add(contrib)
            back[nown:] = 0
            y = add_vec(y, back)
        return y

    return operator.Op(mult=mult)


def _bind_pc_asm(meta, data):
    def mult(x):
        sol = trisolve.trisolve_apply(data, gather(x, data["gather"], check=False))
        if data["set"]:
            return pc_kernels.dst_scatter(data["scatter"], sol, out=torch.zeros_like(x))
        return pc_kernels.dst_scatter(data["scatter"], sol)

    return operator.Op(mult=mult)


# ---------------------------------------------------------------------
# PCComposite
# ---------------------------------------------------------------------

class _PCComposite:
    """PCCOMPOSITE: additive y = sum B_i x, or multiplicative
    y <- y + B_i (x - A y) in turn (composite.c)."""

    def __init__(self, pc):
        self.pc = pc
        self.ctype = "additive"
        self.sub_pcs: list[PC] = []

    def set_from_options(self):
        o = self.pc.opt
        t = o("get_string", "pc_composite_type", None)
        if t:
            self.ctype = t
        s = o("get_string", "pc_composite_pcs", None)
        if s:
            for name in s.split(","):
                self.addPC(name)

    def addPC(self, name_or_pc):
        if isinstance(name_or_pc, PC):
            p = name_or_pc
        else:
            p = PC(options=self.pc._options)
            p.setOperators(self.pc.mat, self.pc.pmat)
            p.setType(name_or_pc)
        self.sub_pcs.append(p)
        return p

    def setup(self):
        if not self.sub_pcs:
            raise Error("PCComposite: no sub-PCs (use -pc_composite_pcs)")
        metas, datas = [], []
        for p in self.sub_pcs:
            p.setOperators(self.pc.mat, self.pc.pmat)
            metas.append(p.meta)
            datas.append(p.device_data())
        return (("pc_composite", self.ctype, tuple(metas), self.pc.pmat.meta),
                {"subs": tuple(datas), "A": self.pc.pmat.device_data()})


def _bind_pc_composite(meta, data):
    _, ctype, metas, amata = meta
    subs = [operator.bind(mi, di) for mi, di in zip(metas, data["subs"])]
    Aop = operator.bind(amata, data["A"])

    def mult(x):
        y = subs[0].mult(x)
        for s in subs[1:]:
            y = add_vec(y, s.mult(x if ctype == "additive" else sub_vec(x, Aop.mult(y))))
        return y

    return operator.Op(mult=mult)


# ---------------------------------------------------------------------
# PCKSP
# ---------------------------------------------------------------------

def inner_ksp_op(ksp):
    """The (meta, data) of a set-up inner KSP's solve as a PC application."""
    cfg = ksp._static_cfg()
    meta = ("pc_ksp", ksp._type, ksp.mat.meta, ksp.pc.meta, cfg,
            float(ksp.rtol), float(ksp.abstol), float(ksp.divtol))
    # inner_its: each application's inner iteration count, appended as it runs
    return meta, {"A": ksp.mat.device_data(), "B": ksp.pc.device_data(), "inner_its": []}


class _PCKSP:
    """PCKSP (pcksp.c): the apply runs an inner KSP on the pmat to its own
    tolerances, configured with the ``ksp_`` options of this PC's prefix.
    An inner max_it above 1000 becomes 20, as in the reference."""

    def __init__(self, pc):
        self.pc = pc
        self.ksp = None

    def getKSP(self):
        if self.ksp is None:
            from ..ksp.ksp import KSP
            self.ksp = KSP(options=self.pc._options,
                           prefix=(self.pc.get_options_prefix() or "") + "ksp_")
            if self.pc.pmat is not None:
                self.ksp.setOperators(self.pc.pmat, self.pc.pmat)
        return self.ksp

    def set_from_options(self):
        self.getKSP()

    def setup(self):
        ksp = self.getKSP()
        ksp.setOperators(self.pc.pmat, self.pc.pmat)
        if ksp._type is None:
            ksp.setFromOptions()
        if ksp.max_it > 1000:
            ksp.max_it = 20
        ksp.setUp()
        return inner_ksp_op(ksp)


def _bind_pc_ksp(meta, data):
    from ..ksp.ksp import _IMPLS
    _, ktype, amata, bmeta, cfg, rtol, abstol, divtol = meta
    fn = _IMPLS[ktype]["fn"]
    A = operator.bind(amata, data["A"])
    B = operator.bind(bmeta, data["B"])

    def mult(x):
        res = fn(A, B, x, torch.zeros_like(x), rtol, abstol, divtol, cfg)
        data["inner_its"].append(int(res.its))
        return res.x

    return operator.Op(mult=mult)


# ---------------------------------------------------------------------
# PCFieldSplit
# ---------------------------------------------------------------------

class _PCFieldSplit:
    """PCFIELDSPLIT (fieldsplit.c): fields from setIS, setFields or the
    block size; types additive, multiplicative, symmetric_multiplicative
    and schur (factorization diag, lower, upper or full; the Schur block
    preconditioned from A11 or selfp, A11 - A10 diag(A00)^-1 A01). The
    sub-PCs take the prefix ``fieldsplit_<name>_``."""

    def __init__(self, pc):
        self.pc = pc
        self.ftype = "multiplicative"
        self.schur_fact = "full"
        self.schur_pre = "a11"
        self.fields: list = []       # (name, index array)
        self.sub_types: dict = {}

    def set_from_options(self):
        o = self.pc.opt
        t = o("get_string", "pc_fieldsplit_type", None)
        if t:
            self.ftype = t
        t = o("get_string", "pc_fieldsplit_schur_fact_type", None)
        if t:
            self.schur_fact = t
        t = o("get_string", "pc_fieldsplit_schur_precondition", None)
        if t:
            self.schur_pre = t

    def setIS(self, name, iset):
        self.fields.append((name, np.asarray(iset, dtype=np.int64)))

    def setFields(self, bs, *fields):
        n = self.pc.pmat.row_layout.N
        for f in fields:
            comps = np.atleast_1d(np.asarray(f, dtype=np.int64))
            idx = np.concatenate([np.arange(c, n, bs) for c in comps])
            self.fields.append((str(len(self.fields)), np.sort(idx)))

    def _default_fields(self):
        bs = self.pc.pmat.row_layout.bs or 1
        if bs <= 1:
            raise Error("PCFieldSplit: call setIS/setFields (no bs to split by)")
        self.setFields(bs, *[[c] for c in range(bs)])

    def setup(self):
        import scipy.sparse as sp
        from ..mat.aij import MatAIJ
        if not self.fields:
            self._default_fields()
        A = self.pc.pmat
        isets = [idx for _, idx in self.fields]
        nf = len(isets)
        # the additive type reads only the diagonal blocks
        need = [(i, j) for i in range(nf) for j in range(nf)
                if i == j or self.ftype != "additive"]
        dist = A.comm.nshards > 1 and hasattr(A, "shardcsr")
        if dist:
            # the distributed split (more_pc.py:509-520): each sub-block from
            # the ShardedCSR's row fetch (MatCreateSubMatrix_MPIAIJ), bound
            # by from_sharded; no gather of the whole operator
            Ssh = A.shardcsr()
            bsh = {(i, j): Ssh.submatrix(isets[i], isets[j]) for i, j in need}
            Ms = {k: MatAIJ.from_sharded(v, A.comm) for k, v in bsh.items()}
            blocks = {k: v.to_global_csr()[: len(isets[k[0]]), : len(isets[k[1]])].tocsr()
                      for k, v in bsh.items()} if self.ftype == "schur" else {}
        else:
            from ..sys.info import warn_full_gather
            warn_full_gather(A, "PCFieldSplit(serial split path)")
            S = A.to_scipy().tocsr()
            rows = [S[ix] for ix in isets]
            blocks = {(i, j): rows[i][:, isets[j]].tocsr() for i, j in need}
            Ms = {k: MatAIJ.from_scipy(v, comm=A.comm) for k, v in blocks.items()}
        sub_pcs = []
        for i in range(nf):
            p = PC(options=self.pc._options,
                   prefix=(self.pc.get_options_prefix() or "") + f"fieldsplit_{self.fields[i][0]}_")
            Mi = Ms[i, i]
            if self.ftype == "schur" and i == 1:
                p._schur_ctx = (blocks[0, 0], blocks[0, 1], blocks[1, 0], blocks[1, 1])
                if self.schur_pre == "selfp" and dist:
                    # Sp = A11 - A10 D0^-1 A01 on the per-rank blocks
                    rl0 = bsh[0, 0].row_layout
                    d0 = np.concatenate(bsh[0, 0].diag_shards())
                    d0 = np.where(d0 == 0, 1.0, d0)
                    vals = [1.0 / d0[s * rl0.block:(s + 1) * rl0.block]
                            for s in range(A.comm.nshards)]
                    A01s = bsh[0, 1].scale_rows(vals)
                    Mi = MatAIJ.from_sharded(bsh[1, 1].add(bsh[1, 0].spmm(A01s) * -1.0), A.comm)
                elif self.schur_pre == "selfp":
                    d0 = blocks[0, 0].diagonal()
                    d0 = np.where(d0 == 0, 1.0, d0)
                    Sp = (blocks[1, 1] - blocks[1, 0] @ sp.diags(1.0 / d0) @ blocks[0, 1]).tocsr()
                    Mi = MatAIJ.from_scipy(Sp, comm=A.comm)
            p.setOperators(Mi, Mi)
            if self.fields[i][0] in self.sub_types:
                p.setType(self.sub_types[self.fields[i][0]])
            p.setFromOptions()
            sub_pcs.append(p)
        self.sub_pcs = sub_pcs
        dev, rd, npad = config.device(), config.real_dtype(), A.row_layout.Npad
        if dist:
            data = {"moves": tuple(_FieldMove(A.row_layout, ix, A.comm) for ix in isets),
                    "subs": tuple(p.device_data() for p in sub_pcs),
                    "blocks": {k: Ms[k].device_data() for k in Ms if k[0] != k[1]}}
            bmetas = tuple((k, Ms[k].meta) for k in Ms if k[0] != k[1])
            return ("pc_fieldsplit", self.ftype, self.schur_fact, npad,
                    tuple(p.meta for p in sub_pcs), bmetas), data
        data = {
            "isets": tuple(torch.as_tensor(ix.astype(np.int32), device=dev) for ix in isets),
            "scatters": tuple(pc_kernels.scatter_table(ix, np.arange(len(ix)), npad, len(ix),
                                                       device=dev, dtype=rd) for ix in isets),
            "subs": tuple(p.device_data() for p in sub_pcs),
            "blocks": {k: Ms[k].device_data() for k in Ms if k[0] != k[1]},
        }
        bmetas = tuple((k, Ms[k].meta) for k in Ms if k[0] != k[1])
        meta = ("pc_fieldsplit", self.ftype, self.schur_fact, npad,
                tuple(p.meta for p in sub_pcs), bmetas)
        return meta, data


class _FieldMove:
    """A field's moves between a distributed vector's blocks and the field's
    sub-vector's blocks (Layout(len(iset), P)): take (the rank's block of
    x[iset], an ExchangePlan over the full layout whose leaves are each
    rank's slice of iset) and put (y[iset] = the field's values for the
    rows this rank owns, a plan over the field layout whose leaves are the
    field positions of those rows, written by X1's set)."""

    def __init__(self, layout, iset, comm):
        from ..parallel.layout import Layout
        from ..parallel.sf import ExchangePlan
        P, r = comm.nshards, comm.rank
        fl = Layout(len(iset), P)
        self.fblk = fl.block
        self.take_plan = ExchangePlan(layout, [iset[slice(*fl.range(s))] for s in range(P)],
                                      comm=comm)
        pos = []
        for s in range(P):
            lo, hi = layout.range(s)
            pos.append(np.nonzero((iset >= lo) & (iset < hi))[0])
        self.put_plan = ExchangePlan(fl, pos, comm=comm)
        lo, _ = layout.range(r)
        n = len(pos[r])
        self.n_take = fl.local_size(r)
        self.put = pc_kernels.scatter_table(iset[pos[r]] - lo, np.arange(n), layout.block,
                                            self.put_plan.H, device=config.device(),
                                            dtype=config.real_dtype())

    def take(self, x):
        halo = self.take_plan.bcast(x)
        out = torch.zeros(self.fblk, dtype=x.dtype, device=x.device)
        out[: self.n_take] = halo[: self.n_take]
        return out

    def put_into(self, y, v):
        return pc_kernels.dst_scatter(self.put, self.put_plan.bcast(v), out=y)


def _bind_pc_fieldsplit(meta, data):
    _, ftype, sfact, npad, sub_metas, bmetas = meta
    nf = len(sub_metas)
    moves = data.get("moves")
    subs = [operator.bind(m_, d_) for m_, d_ in zip(sub_metas, data["subs"])]
    Bop = {k: operator.bind(bm, data["blocks"][k]) for k, bm in bmetas}
    if moves is None:
        isets, scat = data["isets"], data["scatters"]

    def mult(x):
        xs = [mv.take(x) for mv in moves] if moves is not None else \
            [gather(x, ix, check=False) for ix in isets]
        y = torch.zeros_like(x)
        if ftype == "additive":
            ys = [subs[i].mult(xs[i]) for i in range(nf)]
        elif ftype in ("multiplicative", "symmetric_multiplicative"):
            ys = [torch.zeros_like(v) for v in xs]
            order = list(range(nf))
            if ftype == "symmetric_multiplicative":
                order = order + order[-2::-1]
            for i in order:
                ri = xs[i]
                for j in range(nf):
                    if j != i:
                        ri = sub_vec(ri, Bop[i, j].mult(ys[j]))
                ys[i] = subs[i].mult(ri)
        elif ftype == "schur":
            x0, x1 = xs
            B0, B1 = subs
            A01, A10 = Bop[0, 1], Bop[1, 0]
            if sfact == "diag":
                y0 = B0.mult(x0)
                y1 = triad(torch.zeros_like(x1), B1.mult(x1), _one(x1, -1.0))
            elif sfact == "lower":
                y0 = B0.mult(x0)
                y1 = B1.mult(sub_vec(x1, A10.mult(y0)))
            elif sfact == "upper":
                y1 = B1.mult(x1)
                y0 = B0.mult(sub_vec(x0, A01.mult(y1)))
            else:  # full
                t0 = B0.mult(x0)
                y1 = B1.mult(sub_vec(x1, A10.mult(t0)))
                y0 = B0.mult(sub_vec(x0, A01.mult(y1)))
            ys = [y0, y1]
        else:
            raise Error(f"fieldsplit type {ftype}")
        for i in range(nf):
            y = moves[i].put_into(y, ys[i]) if moves is not None else \
                pc_kernels.dst_scatter(scat[i], ys[i], out=y)
        return y

    return operator.Op(mult=mult)


PC.register_impl("sor", _PCSOR)
PC.register_impl("asm", _PCASM)
PC.register_impl("composite", _PCComposite)
PC.register_impl("ksp", _PCKSP)
PC.register_impl("fieldsplit", _PCFieldSplit)
operator.register_binder("pc_sor", _bind_pc_sor)
operator.register_binder("pc_asm", _bind_pc_asm)
operator.register_binder("pc_asm_dist", _bind_pc_asm_dist)
operator.register_binder("pc_composite", _bind_pc_composite)
operator.register_binder("pc_ksp", _bind_pc_ksp)
operator.register_binder("pc_fieldsplit", _bind_pc_fieldsplit)
