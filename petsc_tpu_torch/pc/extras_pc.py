"""The remaining PCs: eisenstat, kaczmarz, deflation, galerkin, mat,
vpbjacobi, redundant, svd, telescope, lsc, gasm, lmvm, redistribute, cp and
patch.

Counterpart of ``petsc_tpu/pc/extras_pc.py`` (src/ksp/pc/impls/{eisens,
kaczmarz, deflation, galerkin, mat, vpbjacobi, redundant, svd, telescope,
lsc, gasm, lmvm, redistribute, cp, patch}), on one device:

* eisenstat, kaczmarz and cp sweep on T1 (``unit_lower_solve``,
  ``unit_upper_solve``); their diagonal scalings are N1 with w = 0
  (d (y - 0) = d y, the same bits), their sums K2;
* gasm and patch are ASM (:mod:`.more_pc`) with the user's or the stars'
  domains, patch's partition-of-unity weights folded into X1's gather and
  its colliding scatter-add;
* lsc and redistribute gather on K8 and X1 and scatter on X1;
* deflation, galerkin, svd, vpbjacobi and lmvm keep their small dense work
  in library torch (``torch.linalg.lu_solve``, ``torch.mv``; ROADMAP queue 2
  item 7 lists the shapes); lmvm's vector steps are K2 and K4;
* mat, redundant and telescope wrap the pmat, LU and an inner KSP.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ksp.common import dot
from ..ops import operator, pc_kernels, trisolve
from ..ops.gather_kernels import gather
from ..ops.pallas_kernels import triad
from ..sys.error import Error
from .more_pc import _PCASM, _PCSOR, add_vec, domain_block_diag, grow_domain, inner_ksp_op, \
    sub_vec
from .pc import PC


def _scale(d, x):
    """d x on N1 (d (x - 0))."""
    return pc_kernels.neumann_step(d, x, torch.zeros_like(x))


def _tensor(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype or config.real_dtype(),
                           device=config.device())


# ---------------------------------------------------------------------
# eisenstat, kaczmarz
# ---------------------------------------------------------------------

class _PCEisenstat(_PCSOR):
    """Eisenstat-trick SSOR (eisens.c): the KSP iterates on
    (E + L)^-1 A (E + U)^-1 xhat = (E + L)^-1 b, E = D / omega, with the PC
    a scaling by D and x = (E + U)^-1 xhat recovered after the solve
    (presolve and postsolve, which the KSP calls); one product of the
    transformed operator is two unit sweeps and a diagonal."""

    def __init__(self, pc):
        super().__init__(pc)
        self.usediag = True

    def set_from_options(self):
        o = self.pc.opt
        w = o("get_real", "pc_eisenstat_omega", None) or o("get_real", "pc_sor_omega", None)
        if w:
            self.omega = w
        if o("get_bool", "pc_eisenstat_no_diagonal_scaling", False):
            self.usediag = False

    def setup(self):
        sor_meta, sor_data = super().setup()
        m = self.pc.pmat.row_layout.N
        d = 1.0 / sor_data["dinv"]
        scale = 2.0 / self.omega - 1.0
        self._shell = (("mat_eisenstat",) + sor_meta[1:5] + (float(self.omega),),
                       {**sor_data, "scale_d": _scale(torch.full_like(d, scale), d)})
        diag = d if self.usediag else torch.ones(m, dtype=d.dtype, device=d.device)
        return ("pc_jacobi",), {"inv": diag}

    def operator_meta_data(self):
        return self._shell

    def presolve(self, b):
        data = self._shell[1]
        return trisolve.unit_lower_solve(data["L"], _scale(data["winv"], b))

    def postsolve(self, x):
        data = self._shell[1]
        return trisolve.unit_upper_solve(data["U"], _scale(data["winv"], x))


def _bind_mat_eisenstat(meta, data):
    def mult(v):
        x = trisolve.unit_upper_solve(data["U"], _scale(data["winv"], v))
        t = sub_vec(v, _scale(data["scale_d"], x))
        t = trisolve.unit_lower_solve(data["L"], _scale(data["winv"], t))
        return add_vec(x, t)

    return operator.Op(mult=mult)


def _unit_lower_sweep(G, w):
    """The unit lower sweep of forward SOR on G with weight w (w D^-1 L) and
    w D^-1 (D the diagonal, zeros made 1)."""
    m = G.shape[0]
    rows = np.repeat(np.arange(m), np.diff(G.indptr))
    d = np.zeros(m)
    dmask = G.indices == rows
    np.add.at(d, rows[dmask], G.data[dmask])
    d = np.where(d == 0, 1.0, d)
    lo = G.indices < rows
    Li = np.concatenate([[0], np.cumsum(np.bincount(rows[lo], minlength=m))])
    sw = trisolve.make_sweep(Li, G.indices[lo], G.data[lo] * (w / d)[rows[lo]], lower=True,
                             dtype=config.real_dtype())
    return sw, d


class _PCKaczmarz:
    """Sequential Kaczmarz (kaczmarz.c): a forward SOR sweep on G = A A^T
    (T1) followed by A^T."""

    def __init__(self, pc):
        self.pc = pc
        self.lmbda = 1.0

    def set_from_options(self):
        v = self.pc.opt("get_real", "pc_kaczmarz_lambda", None)
        if v:
            self.lmbda = v

    def setup(self):
        A = self.pc.pmat
        A_sp = A.to_scipy()
        G = (A_sp @ A_sp.T).tocsr()
        sw, d = _unit_lower_sweep(G, self.lmbda)
        return ("pc_kaczmarz", A.meta), {"A": A.device_data(), "L": sw,
                                         "winv": _tensor(self.lmbda / d)}


def _bind_kaczmarz(meta, data):
    Aop = operator.bind(meta[1], data["A"])
    if Aop.mult_t is None:
        raise Error("kaczmarz: operator needs mult_t")

    def mult(x):
        return Aop.mult_t(trisolve.unit_lower_solve(data["L"], _scale(data["winv"], x)))

    return operator.Op(mult=mult)


# ---------------------------------------------------------------------
# deflation, galerkin, mat, vpbjacobi, redundant, svd
# ---------------------------------------------------------------------

def _lu(E):
    """scipy's LU of a small dense E as torch.linalg.lu_solve's operands."""
    import scipy.linalg as sla
    lu, piv = sla.lu_factor(E)
    return _tensor(lu), torch.as_tensor(piv.astype(np.int32) + 1, device=config.device())


def _lu_solve(lu, piv, b):
    return torch.linalg.lu_solve(lu, piv, b.unsqueeze(1)).squeeze(1)


class _PCDeflation:
    """PCDeflation: y = B x + W (W^T A W)^-1 W^T x with the sub-PC B
    (default jacobi) and the deflation space W (setSpace, or the
    near-nullspace)."""

    def __init__(self, pc):
        self.pc = pc
        self.W = None
        self.sub_type = "jacobi"

    def setSpace(self, W):
        self.W = np.asarray(W, dtype=np.float64)

    def set_from_options(self):
        t = self.pc.opt("get_string", "pc_deflation_sub_type", None)
        if t:
            self.sub_type = t

    def setup(self):
        A = self.pc.pmat
        W = self.W
        if W is None:
            W = getattr(A, "near_nullspace", None)
            if W is None:
                raise Error("PCDeflation: setSpace(W) first")
            W = np.asarray(W.vectors if hasattr(W, "vectors") else W)
        E = W.T @ (A.to_scipy() @ W)
        lu, piv = _lu(E)
        sub = PC(options=self.pc._options)
        sub.setOperators(self.pc.mat, self.pc.pmat)
        sub.setType(self.sub_type)
        Wt = _tensor(W)
        return (("pc_deflation", sub.meta, W.shape[1]),
                {"W": Wt, "Wt": Wt.T.contiguous(), "lu": lu, "piv": piv,
                 "sub": sub.device_data()})


def _bind_deflation(meta, data):
    sub = operator.bind(meta[1], data["sub"])

    def mult(x):
        c = _lu_solve(data["lu"], data["piv"], torch.mv(data["Wt"], x))
        return add_vec(sub.mult(x), torch.mv(data["W"], c))

    return operator.Op(mult=mult)


class _PCGalerkin:
    """PCGALERKIN: y = P (R A P)^-1 R x with the user's P (and R, default
    P^T); the coarse problem solved directly (galerkin.c)."""

    def __init__(self, pc):
        self.pc = pc
        self.P = None
        self.R = None

    def setInterpolation(self, P):
        self.P = P

    def setRestriction(self, R):
        self.R = R

    def setup(self):
        if self.P is None:
            raise Error("PCGalerkin: setInterpolation first")
        Ps = self.P.to_scipy()
        Rs = self.R.to_scipy() if self.R is not None else Ps.T
        C = (Rs @ self.pc.pmat.to_scipy() @ Ps).toarray()
        lu, piv = _lu(C)
        return (("pc_galerkin", C.shape[0]),
                {"P": _tensor(Ps.toarray()), "R": _tensor(Rs.toarray()), "lu": lu,
                 "piv": piv})


def _bind_galerkin(meta, data):
    def mult(x):
        return torch.mv(data["P"], _lu_solve(data["lu"], data["piv"], torch.mv(data["R"], x)))

    return operator.Op(mult=mult)


class _PCMat:
    """PCMAT: the preconditioner is a matrix's product (pcmat.c)."""

    def __init__(self, pc):
        self.pc = pc
        self.M = None

    def setMat(self, M):
        self.M = M

    def setup(self):
        M = self.M if self.M is not None else self.pc.pmat
        return ("pc_mat", M.meta), {"M": M.device_data()}


def _bind_pcmat(meta, data):
    op = operator.bind(meta[1], data["M"])
    return operator.Op(mult=op.mult, mult_t=op.mult_t)


class _PCVPBJacobi:
    """Variable-size point-block Jacobi (vpbjacobi.c): the inverses of the
    diagonal blocks of the given sizes (default the block size), each row
    a padded row of its block's inverse."""

    def __init__(self, pc):
        self.pc = pc
        self.sizes = None

    def setBlockSizes(self, sizes):
        self.sizes = np.asarray(sizes, dtype=np.int64)

    def setup(self):
        A = self.pc.pmat
        m = A.row_layout.N
        if self.sizes is None:
            bs = A.row_layout.bs or 1
            self.sizes = np.full(m // bs, bs, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(self.sizes)])
        A_sp = A.to_scipy().tocsr()
        K = int(self.sizes.max())
        inv_flat = np.zeros((m, K))
        col0 = np.zeros(m, dtype=np.int64)
        for lo, hi in zip(starts[:-1], starts[1:]):
            blk = A_sp[lo:hi, lo:hi].toarray()
            try:
                binv = np.linalg.inv(blk)
            except np.linalg.LinAlgError:
                binv = np.linalg.pinv(blk)
            inv_flat[lo:hi, : hi - lo] = binv
            col0[lo:hi] = lo
        idx = (col0[:, None] + np.arange(K)[None, :]).clip(0, m - 1)
        return (("pc_vpbjacobi", m, K),
                {"inv": _tensor(inv_flat), "idx": torch.as_tensor(idx, device=config.device())})


def _bind_vpbjacobi(meta, data):
    def mult(x):
        return torch.sum(data["inv"] * x[data["idx"]], dim=1)

    return operator.Op(mult=mult)


class _PCRedundant:
    """PCREDUNDANT: every rank solves the whole system (redundant.c); on one
    device, LU."""

    def __init__(self, pc):
        from .factor_pc import _PCLU
        self._inner = _PCLU(pc)
        self.pc = pc

    def setup(self):
        return self._inner.setup()


class _PCSVD:
    """PCSVD: the pseudo-inverse from a dense SVD, singular values below
    1e-12 of the largest dropped."""

    def __init__(self, pc):
        self.pc = pc
        self.zero_sing = 1e-12

    def setup(self):
        A = self.pc.pmat.to_scipy().toarray() if hasattr(self.pc.pmat, "to_scipy") \
            else self.pc.pmat.getDenseArray()
        U, s, Vt = np.linalg.svd(A)
        sinv = np.where(s > self.zero_sing * s.max(), 1.0 / np.where(s == 0, 1.0, s), 0.0)
        pinv = (Vt.T * sinv) @ U.T
        return ("pc_svd", pinv.shape[0]), {"pinv": _tensor(pinv),
                                           "pinv_t": _tensor(np.ascontiguousarray(pinv.T))}


def _bind_svd(meta, data):
    return operator.Op(mult=lambda x: torch.mv(data["pinv"], x),
                       mult_t=lambda x: torch.mv(data["pinv_t"], x))


# ---------------------------------------------------------------------
# telescope, lsc, lmvm, redistribute, cp
# ---------------------------------------------------------------------

class _PCTelescope:
    """PCTelescope (telescope.c): the solve on a smaller communicator; on
    one device an inner KSP (prefix ``telescope_``, max_it above 1000 cut
    to 50) on a copy of the pmat."""

    def __init__(self, pc):
        self.pc = pc
        self.ksp = None

    def getKSP(self):
        if self.ksp is None:
            from ..ksp.ksp import KSP
            self.ksp = KSP(options=self.pc._options,
                           prefix=(self.pc.get_options_prefix() or "") + "telescope_")
        return self.ksp

    def setup(self):
        from ..mat.aij import MatAIJ
        A_rep = MatAIJ.from_scipy(self.pc.pmat.to_scipy())
        ksp = self.getKSP()
        ksp.setOperators(A_rep, A_rep)
        if ksp._type is None:
            ksp.setFromOptions()
        if ksp.max_it > 1000:
            ksp.max_it = 50
        ksp.setUp()
        return inner_ksp_op(ksp)


class _PCLSC:
    """Least-squares commutator for the Schur block of a fieldsplit (lsc.c):
    S^-1 ~ (B B^T)^-1 (B F B^T) (B B^T)^-1, B B^T factored once (SuperLU,
    its sweeps on T1 between K8 permutations), B F B^T three products."""

    def __init__(self, pc):
        self.pc = pc

    def set_from_options(self):
        pass

    def setup(self):
        import scipy.sparse as sp
        from ..mat import factor
        from ..mat.aij import MatAIJ
        from .factor_pc import _with_perm
        ctx = getattr(self.pc, "_schur_ctx", None)
        if ctx is None:
            raise Error("PCLSC: operator is not a Schur complement "
                        "(use inside PCFieldSplit type schur)")
        A00, A01, A10, A11 = ctx
        L = (A10 @ A01).tocsr()
        if np.any(L.diagonal() == 0):
            L = (L + 1e-10 * sp.eye(L.shape[0])).tocsr()
        Lf, Uf, dinv, pr, pcm = factor.splu_factors(L)
        tail, data = trisolve.make_trisolve_plan(Lf, Uf, dinv)
        lmeta, ldata = _with_perm(tail, data, (pr, pcm), L.shape[0])
        B, F, Bt = (MatAIJ.from_scipy(M.tocsr()) for M in (A10, A00, A01))
        return (("pc_lsc", lmeta, B.meta, F.meta, Bt.meta),
                {"L": ldata, "B": B.device_data(), "F": F.device_data(),
                 "Bt": Bt.device_data()})


def _bind_lsc(meta, data):
    _, lmeta, Bmeta, Fmeta, Btmeta = meta
    linv = operator.bind(lmeta, data["L"]).mult
    Bop = operator.bind(Bmeta, data["B"])
    Fop = operator.bind(Fmeta, data["F"])
    Btop = operator.bind(Btmeta, data["Bt"])

    def mult(x):
        y = linv(Bop.mult(Fop.mult(Btop.mult(linv(x)))))
        return triad(torch.zeros_like(y), y, torch.full((), -1.0, dtype=y.dtype,
                                                       device=y.device))

    return operator.Op(mult=mult)


class _PCLMVM:
    """PCLMVM (lmvmpc.c): the limited-memory quasi-Newton inverse Hessian
    (two-loop recursion) from the pairs (s, y) given by update(); with no
    pairs the apply is gamma I. The dots are K4, the updates K2."""

    def __init__(self, pc):
        self.pc = pc
        self.max_pairs = 5
        self._S: list = []
        self._Y: list = []

    def set_from_options(self):
        n = self.pc.opt("get_int", "pc_lmvm_num_vecs", None)
        if n:
            self.max_pairs = n

    def update(self, s, y):
        """MatLMVMUpdate: append a correction pair (curvature-guarded)."""
        s = np.asarray(s, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if float(np.dot(s, y)) > 1e-30 * float(np.linalg.norm(s) * np.linalg.norm(y) + 1e-300):
            self._S.append(s)
            self._Y.append(y)
            if len(self._S) > self.max_pairs:
                self._S.pop(0)
                self._Y.pop(0)
        self.pc._setup_called = False
        return self

    def reset(self):
        self._S.clear()
        self._Y.clear()
        self.pc._setup_called = False

    def setup(self):
        k = len(self._S)
        if k == 0:
            return ("pc_lmvm", 0), {"gamma": _tensor(1.0)}
        S, Y = np.stack(self._S), np.stack(self._Y)
        rho = 1.0 / np.einsum("ij,ij->i", S, Y)
        gamma = float(np.dot(self._S[-1], self._Y[-1]) / np.dot(self._Y[-1], self._Y[-1]))
        return ("pc_lmvm", k), {"S": _tensor(S), "Y": _tensor(Y), "rho": _tensor(rho),
                                "gamma": _tensor(gamma)}


def _bind_lmvm(meta, data):
    k = meta[1]

    def mult(g):
        q = g
        alphas = []
        for i in range(k - 1, -1, -1):
            a = data["rho"][i] * dot(data["S"][i], q)
            alphas.append((i, a))
            q = triad(q, data["Y"][i], -a)
        q = triad(torch.zeros_like(q), q, data["gamma"])
        for i, a in reversed(alphas):
            b = data["rho"][i] * dot(data["Y"][i], q)
            q = triad(q, data["S"][i], a - b)
        return q

    return operator.Op(mult=mult)


class _PCRedistribute:
    """PCREDISTRIBUTE (redistribute.c): rows with only a diagonal entry are
    solved directly (x_i = b_i / a_ii), the rest by an inner KSP (prefix
    ``redistribute_``) with their couplings to the stripped rows moved to
    the right-hand side."""

    def __init__(self, pc):
        self.pc = pc

    def set_from_options(self):
        pass

    def setup(self):
        from ..ksp.ksp import KSP
        from ..mat.aij import MatAIJ
        A = self.pc.pmat
        S = A.to_scipy().tocsr()
        n = S.shape[0]
        diag = S.diagonal()
        one = np.diff(S.indptr) == 1
        dec = one & (diag != 0)
        dec[one] &= S.indices[S.indptr[:-1][one]] == np.nonzero(one)[0]
        kidx, didx = np.nonzero(~dec)[0], np.nonzero(dec)[0]
        Am = MatAIJ.from_scipy(S[kidx][:, kidx].tocsr(), comm=A.comm)
        inner = KSP(options=self.pc._options,
                    prefix=(self.pc.get_options_prefix() or "") + "redistribute_")
        inner.setOperators(Am, Am)
        inner.setFromOptions()
        if inner._type is None:
            inner.setType("gmres")
        inner.setUp()
        self.ksp = inner
        kmeta, kdata = inner_ksp_op(inner)
        dev, rd = config.device(), config.real_dtype()
        nk, nd = len(kidx), len(didx)
        data = {"ksp": kdata, "kidx": torch.as_tensor(kidx.astype(np.int32), device=dev),
                "put_k": pc_kernels.scatter_table(kidx, np.arange(nk), n, nk, device=dev,
                                                  dtype=rd)}
        adk_meta = None
        if nd:
            Adk = MatAIJ.from_scipy(S[kidx][:, didx].tocsr(), comm=A.comm)
            adk_meta = Adk.meta
            data.update(Adk=Adk.device_data(),
                        get_d=pc_kernels.scatter_table(np.arange(nd), didx, nd, n,
                                                       1.0 / diag[didx], device=dev, dtype=rd),
                        put_d=pc_kernels.scatter_table(didx, np.arange(nd), n, nd, device=dev,
                                                       dtype=rd))
        return ("pc_redistribute", kmeta, adk_meta), data


def _bind_redistribute(meta, data):
    _, kmeta, adk_meta = meta
    inner = operator.bind(kmeta, data["ksp"])
    Adk = operator.bind(adk_meta, data["Adk"]) if adk_meta is not None else None

    def mult(b):
        bk = gather(b, data["kidx"], check=False)
        if Adk is not None:
            xd = pc_kernels.dst_scatter(data["get_d"], b)
            bk = sub_vec(bk, Adk.mult(xd))
        y = pc_kernels.dst_scatter(data["put_k"], inner.mult(bk), out=torch.zeros_like(b))
        if Adk is not None:
            y = pc_kernels.dst_scatter(data["put_d"], xd, out=y)
        return y

    return operator.Op(mult=mult)


class _PCCP:
    """PCCP (cp.c): one sweep of column projections, forward Gauss-Seidel on
    A^T A x = A^T b: A^T on S2, the unit lower sweep on T1."""

    def __init__(self, pc):
        self.pc = pc

    def set_from_options(self):
        pass

    def setup(self):
        import scipy.sparse as sp
        from ..mat.aij import MatAIJ
        A = self.pc.pmat
        S = A.to_scipy().tocsr()
        N = (S.T @ S).tocsr()
        d = N.diagonal()
        d = np.where(d == 0, 1.0, d)
        Ls = (sp.diags(1.0 / d) @ sp.tril(N, k=-1)).tocsr()
        At = MatAIJ.from_scipy(sp.csr_matrix(S.T), comm=A.comm)
        return (("pc_cp", At.meta),
                {"L": trisolve.make_sweep(Ls.indptr, Ls.indices, Ls.data, lower=True,
                                          dtype=config.real_dtype()),
                 "dinv": _tensor(1.0 / d), "At": At.device_data()})


def _bind_cp(meta, data):
    At = operator.bind(meta[1], data["At"])

    def mult(b):
        return trisolve.unit_lower_solve(data["L"], _scale(data["dinv"], At.mult(b)))

    return operator.Op(mult=mult)


# ---------------------------------------------------------------------
# gasm, patch: ASM with other domains
# ---------------------------------------------------------------------

class _PCGASM(_PCASM):
    """Generalized ASM (gasm.c): additive Schwarz on the user's inner
    (owned) and outer (overlapped) subdomains (setSubdomains)."""

    def __init__(self, pc):
        super().__init__(pc)
        self.user_doms = None

    def set_from_options(self):
        o = self.pc.opt
        n = o("get_int", "pc_gasm_total_subdomains", None)
        if n:
            self.nblocks = n
        v = o("get_int", "pc_gasm_overlap", None)
        if v is not None:
            self.overlap = v
        t = o("get_string", "pc_gasm_type", None)
        if t:
            self.asm_type = t

    def setSubdomains(self, inner, outer=None):
        inner = [np.asarray(ix, dtype=np.int64) for ix in inner]
        outer = ([np.asarray(ix, dtype=np.int64) for ix in outer] if outer is not None
                 else [ix.copy() for ix in inner])
        self.user_doms = list(zip(inner, outer))
        return self

    def _default_domains(self, S, m):
        if self.user_doms is None:
            return super()._default_domains(S, m)
        return [(own, grow_domain(S, dom, self.overlap) if self.overlap else dom)
                for own, dom in self.user_doms]


class _PCPatch(_PCASM):
    """PCPATCH: additive relaxation over vertex stars (each dof and its
    matrix-graph neighbours, the centre last), all patches one block-
    diagonal ILU(0); the partition-of-unity weights w = mult^-1/2 on both
    sides (inside X1's gather and scatter)."""

    def __init__(self, pc):
        super().__init__(pc)
        self.overlap = 0
        self.asm_type = "basic"
        self.sub_kind = "star"

    def set_from_options(self):
        t = self.pc.opt("get_string", "pc_patch_construct_type", None)
        if t:
            self.sub_kind = t

    def _default_domains(self, S, m):
        S = S.tocsr().copy()
        S.sum_duplicates()
        S.sort_indices()
        rows = np.repeat(np.arange(m), np.diff(S.indptr))
        off = S.indices != rows
        leaves = np.split(S.indices[off], np.cumsum(np.bincount(rows[off], minlength=m))[:-1])
        return [(np.asarray([i], dtype=np.int64), np.append(lv, i).astype(np.int64))
                for i, lv in enumerate(leaves)]

    _kind = "pc_patch"

    def _weights(self, gat, m):
        """The partition of unity mult^-1/2 (mult: the patches a dof is in),
        on both sides of the patch solves: the sum stays symmetric."""
        return 1.0 / np.sqrt(np.maximum(np.bincount(gat, minlength=m), 1.0))


def _bind_patch(meta, data):
    def mult(x):
        sol = trisolve.trisolve_apply(data, pc_kernels.dst_scatter(data["wgather"], x))
        return pc_kernels.dst_scatter(data["scatter"], sol)

    return operator.Op(mult=mult)


for _name, _impl in (("eisenstat", _PCEisenstat), ("kaczmarz", _PCKaczmarz),
                     ("deflation", _PCDeflation), ("galerkin", _PCGalerkin), ("mat", _PCMat),
                     ("vpbjacobi", _PCVPBJacobi), ("redundant", _PCRedundant), ("svd", _PCSVD),
                     ("telescope", _PCTelescope), ("lsc", _PCLSC), ("gasm", _PCGASM),
                     ("lmvm", _PCLMVM), ("redistribute", _PCRedistribute), ("cp", _PCCP),
                     ("patch", _PCPatch)):
    PC.register_impl(_name, _impl)
for _kind, _binder in (("mat_eisenstat", _bind_mat_eisenstat), ("pc_kaczmarz", _bind_kaczmarz),
                       ("pc_deflation", _bind_deflation), ("pc_galerkin", _bind_galerkin),
                       ("pc_mat", _bind_pcmat), ("pc_vpbjacobi", _bind_vpbjacobi),
                       ("pc_svd", _bind_svd), ("pc_lsc", _bind_lsc), ("pc_lmvm", _bind_lmvm),
                       ("pc_redistribute", _bind_redistribute), ("pc_cp", _bind_cp),
                       ("pc_patch", _bind_patch)):
    operator.register_binder(_kind, _binder)
