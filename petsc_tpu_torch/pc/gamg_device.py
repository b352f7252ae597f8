"""The structured GAMG head on the device: the Galerkin product of a grid
stencil by period-3 stencil probing, and Lanczos bounds.

Counterpart of ``petsc_tpu/pc/gamg_device.py``. When the fine operator
is an ``aij_dnd`` grid stencil with offsets in {-1,0,1}^d and the
transfer is the separable Q1 interpolation (:mod:`..dm.interp`), the
coarse operator Ac = P^T A P is again a {-1,0,1}^d (27-point in 3-D)
grid stencil. Its coefficient planes are recovered exactly, boundary
clips included, by probing with the 3^d period-3 lattice combs: within
the stencil support of any coarse point lies exactly one comb point of
each residue class, so

    g_r = P^T A P e_r   (e_r = indicator of {I : I mod 3 == r})
    Ac[I, I+O] = g_{(I+O) mod 3}[I]

Each probe is one Q1P, one product with A (S1 or V1) and one Q1R on the
card, run one after the other as the reference's ``lax.map`` does (one
fine-grid temporary at a time); the residues are picked with
``torch.gather``. Chebyshev bounds come from a 10-step Lanczos on
D^-1/2 A D^-1/2 from the reference's start vector (JAX's threefry with
key 7, :func:`..ops.esteig.uniform`); every level's (alpha, beta) stay on
the card until one ``.cpu()`` brings them all (``emax_batch``). The small
coarse tail comes to the host once as CSR (``dnd_to_csr``) for the
aggregation loop.

The slab-sharded forms (gamg_device.py:172-247): ``device_rap_dnd_mpi``
probes a ``dnd_mpi`` operator with the rank's part of the same combs,
through the slab Q1 transfer (:class:`..dm.interp.MatInterpQ1MPI`, Q1P and
Q1R on the slab with a halo plane) and the slab stencil (V1 on the slab
with its halo planes); the residues are picked on the rank's coarse slab,
whose planes carry the halo rows the dnd_mpi layout keeps. Its Lanczos
sums over the ranks; ``mpi_to_csr`` gathers a small level's planes from
every rank once (the telescope hand-off to the serial aggregation).
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from ..ops import operator
from ..ops.esteig import uniform
from ..ops.grid_kernels import q1_prolong, q1_restrict
from ..ops.stencil_build import dnd_to_csr, nnz_of

_NP = {torch.float64: np.float64, torch.float32: np.float32}


def _as_tuple(x):
    return tuple(int(v) for v in x)


def _shape_of(meta):
    """Grid shape of a stencil operator's meta (one device or slab-sharded)."""
    if meta[0] == "aij_dnd":
        return _as_tuple(meta[1])
    if meta[0] == "dnd_mpi":
        return _as_tuple(meta[3])
    raise ValueError(meta[0])


def supports_device_rap(meta, kinds=("aij_dnd",)):
    """True when `meta` is a grid stencil of one of `kinds` whose offsets
    fit in the {-1,0,1}^d box (star and box stencils; closed under Q1
    coarsening)."""
    if not meta or meta[0] not in kinds:
        return False
    offs = meta[2] if meta[0] == "aij_dnd" else meta[4]
    return all(all(abs(int(c)) <= 1 for c in o) for o in offs)


def head_data(A_data, dtype=None):
    """The probe's and Lanczos's view of an operator's data: its planes and
    diagonal, cast to the cycle's dtype (-pc_mg_dtype single probes and
    stores the head in float32, gamg.py:510-513); a slab operator's comm
    rides along."""
    out = {"coef": A_data["coef"], "diag": A_data["diag"]}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    if "comm" in A_data:
        out["comm"] = A_data["comm"]
    return out


def _probe(A_meta, data, cshape, comm=None):
    """(planes, diagonal) of P^T A P on the coarse grid `cshape`
    (gamg_device.py:66-139); on a slab operator, those of the rank's coarse
    slab, the transfers the slab Q1 (MatInterpQ1MPI)."""
    fshape = _shape_of(A_meta)
    nd = len(fshape)
    Aop = operator.bind(A_meta, data)
    d = data["diag"]
    rd, dev = d.dtype, d.device
    lshape, z0 = tuple(cshape), 0
    prolong = lambda e: q1_prolong(e, fshape)           # noqa: E731
    restrict = lambda f: q1_restrict(f, fshape)         # noqa: E731
    if comm is not None:
        from ..dm.interp import MatInterpQ1MPI
        nzl = cshape[0] // comm.nshards
        lshape, z0 = (nzl,) + tuple(cshape[1:]), comm.rank * nzl
        Pq = MatInterpQ1MPI(fshape, cshape, comm)
        Pop = operator.bind(Pq.meta, Pq.device_data())
        prolong, restrict = Pop.mult, Pop.mult_t
    iotas = [torch.arange(z0 if ax == 0 else 0, (z0 if ax == 0 else 0) + lshape[ax],
                          device=dev).reshape([lshape[ax] if a == ax else 1 for a in range(nd)])
             for ax in range(nd)]
    # the base-3 residue id of every coarse point (the first axis is the
    # most significant digit, as the comb enumeration below)
    rid0 = torch.zeros(lshape, dtype=torch.int64, device=dev)
    for ax in range(nd):
        rid0 = rid0 * 3 + iotas[ax] % 3
    rid0 = rid0.reshape(-1)
    G = torch.empty((3 ** nd, rid0.numel()), dtype=rd, device=dev)
    for r in range(3 ** nd):
        e = (rid0 == r).to(rd)
        G[r] = restrict(Aop.mult(prolong(e)))
    offs27 = list(product((-1, 0, 1), repeat=nd))
    coef = torch.empty((len(offs27),) + lshape, dtype=rd, device=dev)
    for k, o in enumerate(offs27):
        # coef_O[I] = g_{(I+O) mod 3}[I]
        acc = torch.zeros(lshape, dtype=torch.int64, device=dev)
        for ax in range(nd):
            acc = acc * 3 + (iotas[ax] + o[ax]) % 3
        coef[k] = torch.gather(G, 0, acc.reshape(1, -1))[0].reshape(lshape)
    return coef, coef[offs27.index((0,) * nd)].reshape(-1)


def device_rap_dnd(A_meta, A_data, cshape, dtype=None):
    """(coarse meta, coarse data) of Ac = P^T A P for a dnd fine operator,
    computed on A's device; P is MatInterpQ1(fine shape -> cshape)."""
    cshape = _as_tuple(cshape)
    nd = len(cshape)
    coef, diag = _probe(A_meta, head_data(A_data, dtype), cshape)
    meta = ("aij_dnd", cshape, tuple(product((-1, 0, 1), repeat=nd)), (1,) * nd, (1,) * nd,
            int(np.prod(cshape)))
    return meta, {"coef": coef, "diag": diag}


def device_rap_dnd_mpi(A_meta, A_data, cshape, comm, dtype=None):
    """(coarse dnd_mpi meta, data) of Ac = P^T A P for a slab-sharded fine
    stencil (gamg_device.py:172-203): the rank's coarse planes, with one
    zero halo row a side as the dnd_mpi layout keeps them. The caller
    checks that cshape[0] divides over the ranks."""
    cshape = _as_tuple(cshape)
    nd = len(cshape)
    P = comm.nshards
    coef, diag = _probe(A_meta, head_data(A_data, dtype), cshape, comm)
    K, nzl = coef.shape[0], cshape[0] // P
    ext = torch.zeros((K, nzl + 2) + cshape[1:], dtype=coef.dtype, device=coef.device)
    ext[:, 1:nzl + 1] = coef
    meta = ("dnd_mpi", P, nzl, cshape, tuple(product((-1, 0, 1), repeat=nd)), 1)
    return meta, {"coef": ext, "diag": diag.contiguous(), "comm": comm}


def as_mat_mpi(meta, data, comm):
    """A probed dnd_mpi coarse level as a Mat (the sharded sibling of
    stencil_build.as_mat, gamg_device.py:206-230)."""
    from ..mat.mat import Mat

    class _ShardedStencilMat(Mat):
        @property
        def meta(self):
            return self._meta_val

        def device_data(self):
            return self._data_val

        def nnz(self):
            return nnz_of(self._grid_shape, self._meta_val[4])

        def to_scipy(self):
            return mpi_to_csr(self._meta_val, self._data_val)

    M = _ShardedStencilMat(comm)
    shape = _as_tuple(meta[3])
    N = int(np.prod(shape))
    M.setSizes((N, N))
    M._meta_val = meta
    M._data_val = data
    M._grid_shape = shape
    M._assembled = True
    return M


def mpi_to_csr(meta, data):
    """A (small) dnd_mpi level as a host CSR, its planes gathered from every
    rank once (gamg_device.py:233-247: the telescope hand-off to the serial
    aggregation)."""
    _, P, nzl, shape, offs, s = meta
    shape = _as_tuple(shape)
    comm, coef = data["comm"], data["coef"]
    K = coef.shape[0]
    mine = coef[:, s:s + nzl].contiguous()
    allp = comm.allgather(mine.transpose(0, 1).contiguous())   # (P nzl, K, tail)
    planes = allp.reshape((shape[0], K) + shape[1:]).transpose(0, 1)
    smeta = ("aij_dnd", shape, tuple(offs), None, None, int(np.prod(shape)))
    return dnd_to_csr(smeta, {"coef": planes})


def _lanczos(A_meta, data, m, seed):
    """m steps of the 3-term Lanczos recurrence on D^-1/2 A D^-1/2
    (gamg_device.py:249-303): (alphas, betas) as tensors on A's device. On
    a slab operator each rank starts from its slab of the same global
    vector and every dot and norm sums over the ranks."""
    shape = _shape_of(A_meta)
    n = int(np.prod(shape))
    Aop = operator.bind(A_meta, data)
    d = data["diag"]
    rd, dev = d.dtype, d.device
    # a constant-diagonal stencil (meta[6]) folds the similarity scaling to scalars
    const_diag = None
    if len(A_meta) > 6:
        center = (0,) * len(shape)
        if center in A_meta[2]:
            const_diag = A_meta[6][list(A_meta[2]).index(center)]
    if const_diag is not None:
        c = float(const_diag)
        dis = torch.tensor(1.0 / np.sqrt(abs(c)) if c != 0 else 1.0, dtype=rd, device=dev)
        sgn = torch.tensor(-1.0 if c < 0 else 1.0, dtype=rd, device=dev)
    else:
        dis = torch.where(d != 0, 1.0 / torch.sqrt(torch.abs(torch.where(d == 0, 1.0, d))), 1.0)
        sgn = torch.where(d < 0, -1.0, 1.0).to(rd)
    np_dt = _NP[rd]
    comm = data.get("comm")
    u = uniform(seed, n, np_dt) - np_dt(0.5)
    if comm is not None:
        blk = n // comm.nshards
        u = u[comm.rank * blk:(comm.rank + 1) * blk]

    def dot(a, b):
        t = torch.dot(a, b)
        return t if comm is None else comm.allreduce_(t)

    def nrm(a):
        return torch.linalg.vector_norm(a) if comm is None else torch.sqrt(dot(a, a))

    v = torch.as_tensor(u, device=dev)
    v = v / nrm(v)
    tiny = torch.tensor(1e-300, dtype=rd, device=dev)
    v_prev, beta_prev = torch.zeros_like(v), torch.zeros((), dtype=rd, device=dev)
    alphas, betas = [], []
    for _ in range(m):
        w = sgn * dis * Aop.mult(dis * v) - beta_prev * v_prev
        alpha = dot(w, v)
        w = w - alpha * v
        beta = nrm(w)
        v_prev, v, beta_prev = v, w / torch.maximum(beta, tiny), beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)


def lanczos_futures(A_meta, A_data, iters=10, seed=7, dtype=None):
    """(alphas, betas) left on the card, not fetched: emax_batch brings
    many levels' recurrences to the host together."""
    n = int(np.prod(_shape_of(A_meta)))
    return _lanczos(A_meta, head_data(A_data, dtype), int(min(iters, n)), seed)


def emax_batch(abs_list):
    """The largest Ritz value of each level's recurrence, all levels'
    (alphas, betas) brought to the host in one ``.cpu()``."""
    if not abs_list:
        return []
    flat = torch.cat([torch.cat([a, b]) for a, b in abs_list]).cpu().numpy()
    out, pos = [], 0
    for a, _ in abs_list:
        m = a.shape[0]
        alphas, betas = flat[pos:pos + m], flat[pos + m:pos + 2 * m]
        pos += 2 * m
        T = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
        out.append(float(np.max(np.linalg.eigvalsh(T))))
    return out


def device_emax(A_meta, A_data, iters=10, seed=7, dtype=None):
    """Largest Ritz value of D^-1 A from a 10-step Lanczos on the similar
    symmetric operator D^-1/2 A D^-1/2 (the esteig role of
    mg._host_emax, agg.c:1855-1899), with one fetch."""
    return emax_batch([lanczos_futures(A_meta, A_data, iters, seed, dtype)])[0]
