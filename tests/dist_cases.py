"""What the ranks of a distributed CPU test run (tests/dist_parity.py):
each function runs on every rank of the group, on the port, and returns a
picklable result (numpy arrays, floats). No jax here: the tests compare
these results with the JAX package in their own process.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _pt(args=(), dtype=None):
    import petsc_tpu_torch as ptt
    ptt.init(args=list(args), device="cpu")
    return ptt


def _comm(two_level=False):
    import torch.distributed as dist
    from petsc_tpu_torch.parallel.mesh import make_comm, make_comm2
    P = dist.get_world_size()
    return make_comm2(2, P // 2) if two_level else make_comm(P)


# ---------------------------------------------------------------------
# operators (the same assemblies as the reference's examples)
# ---------------------------------------------------------------------

def poisson2d(n):
    """ex2.c's 5-point Laplacian (__graft_entry__._poisson2d)."""
    N = n * n
    side = -np.ones(N - 1)
    side[np.arange(1, N) % n == 0] = 0.0
    return sp.diags([4.0 * np.ones(N), side, side, -np.ones(N - n), -np.ones(N - n)],
                    [0, 1, -1, n, -n], format="csr")


def laplace7(n, shift=0.0):
    """The dryrun's 7-point Laplacian on n^3 (plus shift I)."""
    I = sp.eye(n)
    T = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1])
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T)).tocsr()
    return (A + sp.eye(n ** 3) * shift).tocsr() if shift else A


def box27(n):
    from petsc_tpu_torch.ops.stencil_build import poisson3d_27pt
    return poisson3d_27pt(n).tocsr()


def operator(name, n):
    return {"poisson2d": lambda: poisson2d(n), "laplace7": lambda: laplace7(n),
            "laplace7_shift": lambda: laplace7(n, 0.5), "box27": lambda: box27(n)}[name]()


# ---------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------

def solve(op, n, args, grid=False, rhs="ones", fields=None, two_level=False,
          with_x=True):
    """One KSP solve on the distributed operator: (its, reason, history,
    the gathered solution, [(A kind, rows) per MG level], the launch
    counts of the solve). rhs: "ones" (b = 1) or "A1" (b = A 1)."""
    from petsc_tpu_torch.parallel.mesh import reducing
    ptt = _pt(args)
    comm = _comm(two_level)
    A_sp = operator(op, n)
    A = ptt.MatAIJ.from_scipy(A_sp, comm=comm)
    if grid:
        A.setStencilGrid(grid if isinstance(grid, tuple) else (n,) * 3)
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    if fields is not None:
        N = A_sp.shape[0]
        ksp.getPC().setFieldSplitIS(*[(str(k), np.arange(k, N, fields))
                                      for k in range(fields)])
    b = A.createVecLeft()
    b.setArray(np.ones(A_sp.shape[0]) if rhs == "ones" else A_sp @ np.ones(A_sp.shape[0]))
    x = A.createVecRight()
    ksp.solve(b, x)
    levels = getattr(ksp.getPC()._impl, "levels", None) or []
    with reducing(None):
        xs = x.getArray() if with_x else None
    return {"its": ksp.getIterationNumber(), "reason": ksp.getConvergedReason().name,
            "history": np.asarray(ksp.getConvergenceHistory()), "x": xs,
            "A_kind": A.meta[0],
            "levels": [(lev.A.meta[0], lev.A.getSize()[0]) for lev in levels],
            "emax": [lev.emax for lev in levels[:-1]]}


# ---------------------------------------------------------------------
# the exchange (parallel/sf.py) and the vectors
# ---------------------------------------------------------------------

def sf_case(N, leaves, max_neighbors, x_global, leaf_vals):
    """ExchangePlan's run-time and set-up operations on this rank:
    (halo, reduce_add, gather, fetch_and_add, composed leaves, lowering)."""
    import torch
    from petsc_tpu_torch.parallel.layout import Layout
    from petsc_tpu_torch.parallel.sf import ExchangePlan
    _pt()
    comm = _comm()
    r = comm.rank
    lay = Layout(N, comm.nshards)
    plan = ExchangePlan(lay, leaves, max_neighbors=max_neighbors, comm=comm)
    blk = lay.block
    xl = torch.as_tensor(np.asarray(x_global)[r * blk:(r + 1) * blk])
    lv = torch.as_tensor(np.asarray(leaf_vals)[r])
    fetched, upd = plan.fetch_and_add(xl, lv)
    other = ExchangePlan(lay, [np.arange(len(l))[::2] for l in leaves], comm=comm)
    return {"halo": plan.bcast(xl).numpy(), "reduce": plan.reduce_add(lv).numpy(),
            "gather": plan.gather(lv).numpy(), "fetched": fetched.numpy(),
            "updated": upd.numpy(), "allgather": plan.use_allgather,
            "composed": [np.asarray(a) for a in plan.compose(other).leaves_per_shard],
            "tables": plan.meta()}


def scatter_case(N, ix, iy, x_global, y_global, addv):
    """VecScatter across layouts: the gathered y."""
    from petsc_tpu_torch.parallel.sf import VecScatter
    ptt = _pt()
    comm = _comm()
    x = ptt.Vec.from_array(np.asarray(x_global), comm=comm)
    y = ptt.Vec.from_array(np.asarray(y_global), comm=comm)
    VecScatter(x.layout, ix, y.layout, iy, comm=comm).apply(x, y, addv=addv)
    return y.getArray()


def ghost_case(N, ghosts_per_rank, x_global, ghost_adds):
    """VecGhost: the forward update's ghost values, the local form, the
    reverse ADD and INSERT results (gathered)."""
    import torch
    from petsc_tpu_torch.vec.ghost import VecGhost
    from petsc_tpu_torch.vec.vec import InsertMode
    _pt()
    comm = _comm()
    r = comm.rank
    v = VecGhost.createGhost(N, ghosts_per_rank[r], comm=comm)
    v.setArray(np.asarray(x_global))
    v.ghostUpdate(InsertMode.INSERT_VALUES, "forward")
    fwd = v._ghost_vals.numpy().copy()
    local = v.getLocalForm().numpy()
    v._ghost_vals = torch.as_tensor(np.asarray(ghost_adds[r]))
    v.ghostUpdate(InsertMode.ADD_VALUES, "reverse")
    added = v.getArray()
    v._ghost_vals = torch.as_tensor(np.asarray(ghost_adds[r]))
    v.ghostUpdate(InsertMode.INSERT_VALUES, "reverse")
    return {"forward": fwd, "local": local, "added": added, "inserted": v.getArray()}


def nest_case(parts):
    from petsc_tpu_torch.vec.nest import VecNest
    ptt = _pt()
    comm = _comm()
    subs = [ptt.Vec.from_array(np.asarray(p), comm=comm) for p in parts]
    nv = VecNest.create(subs, comm=comm)
    flat = nv.getArray()
    nv.set(2.0)
    back = [s.getArray() for s in nv.getNestSubVecs()]
    return {"flat": flat, "size": nv.getNestSize(), "subs": back,
            "norm": nv.norm(), "local": nv.getLocalSize()}


def vec_case(x_global, y_global):
    """Vec's sharded surface: dot, norms, sum, max, min, axpy, scale, set,
    setValues, getArray, the ownership range."""
    from petsc_tpu_torch.vec.vec import NormType
    ptt = _pt()
    comm = _comm()
    x = ptt.Vec.from_array(np.asarray(x_global), comm=comm)
    y = ptt.Vec.from_array(np.asarray(y_global), comm=comm)
    out = {"dot": x.dot(y), "norm2": x.norm(), "norm1": x.norm(NormType.NORM_1),
           "norminf": x.norm(NormType.NORM_INFINITY), "sum": x.sum(), "max": x.max(),
           "min": x.min(), "range": x.getOwnershipRange(), "local": x.getLocalSize(),
           "dotnorm2": x.dotNorm2(y)}
    z = x.copy()
    z.axpy(0.5, y)
    z.scale(3.0)
    out["axpy_scale"] = z.getArray()
    w = x.duplicate()
    w.set(1.5)
    w.setValues([0, len(x_global) - 1], [7.0, 9.0])
    out["set"] = w.getArray()
    out["set_norm"] = w.norm()
    return out


def vec_pointwise_case(x_global, y_global):
    """The pointwise operations that would leave the last rank's padding
    non-zero (0/0, e^0), each followed by the reductions that sum over
    it; and fused_reductions outside a solve."""
    ptt = _pt()
    comm = _comm()
    x = ptt.Vec.from_array(np.asarray(x_global), comm=comm)
    y = ptt.Vec.from_array(np.asarray(y_global), comm=comm)
    out = {}
    for name, op in (("exp", lambda w: w.exp()), ("log", lambda w: w.log()),
                     ("divide", lambda w: w.pointwiseDivide(x, y))):
        w = x.copy()
        op(w)
        out[name] = (w.sum(), w.norm(), w.dot(y), w.getArray())
    out["fused"] = ptt.fused_reductions([("dot", x, y), ("norm2", x), ("norm1", y),
                                         ("norminf", x)])
    return out


def pair_classes_case(hosts):
    """make_comm2's pair classes for offsets +1 and -1."""
    import torch.distributed as dist
    from petsc_tpu_torch.parallel.mesh import make_comm2
    _pt()
    c = make_comm2(hosts, dist.get_world_size() // hosts)
    P = c.nshards
    return {"classes": c.halo_pair_classes((1, -1)),
            "pairs": [c.pair_class(j, (j - 1) % P) for j in range(P)], "nshards": P}


# ---------------------------------------------------------------------
# products
# ---------------------------------------------------------------------

def mult_case(meta, data, size, x_global, grid=None, A_csr=None):
    """A distributed operator carried from the reference's (meta, data)
    (interop), and the same built from its CSR: (y = A x, y = A^T x) of
    each, gathered, and the layout kind."""
    from petsc_tpu_torch.interop import mat_from_meta_data, mat_from_csr
    ptt = _pt()
    comm = _comm()
    out = {}
    mats = {"interop": mat_from_meta_data(meta, data, comm=comm, size=size)}
    if A_csr is not None:
        mats["csr"] = mat_from_csr(*A_csr, shape=size, comm=comm, grid=grid)
    for name, A in mats.items():
        x = A.createVecRight()
        x.setArray(np.asarray(x_global)[: size[1]])
        y = A.createVecLeft()
        A.mult(x, y)
        out[name] = {"kind": A.meta[0], "y": y.getArray()}
        if size[0] == size[1]:
            yt = A.createVecRight()
            A.multTranspose(x, yt)
            out[name]["yt"] = yt.getArray()
        out[name]["diag"] = A.getDiagonal().getArray()
    return out


def coo_case(coo_i, coo_j, value_sets, size, x_global, grid=None):
    """A MatAIJ assembled from COO triplets on the ranks (setPreallocationCOO
    once, then the same pattern again before each later setValuesCOO): per
    value set, (y = A x, y = A^T x, the diagonal, all gathered; the host
    CSR, read back from the ranks' device blocks; the K8 gathers that
    setValuesCOO made, counted on their plain version; whether the host
    values were left stale)."""
    from petsc_tpu_torch.ops import gather_kernels
    ptt = _pt()
    comm = _comm()
    A = ptt.MatAIJ(comm)
    A.setSizes(size)
    if grid is not None:
        A.setStencilGrid(grid)
    orig, count = gather_kernels.gather_plain, [0]

    def counted(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)
    out = []
    for vals in value_sets:
        A.setPreallocationCOO(coo_i, coo_j)
        gather_kernels.gather_plain = counted
        try:
            count[0] = 0
            A.setValuesCOO(np.asarray(vals))
            gathers = count[0]
        finally:
            gather_kernels.gather_plain = orig
        stale = A._vals is None
        x = A.createVecRight()
        x.setArray(np.asarray(x_global)[: size[1]])
        y, yt = A.createVecLeft(), A.createVecRight()
        A.mult(x, y)
        if size[0] == size[1]:
            A.multTranspose(x, yt)
        out.append({"kind": A.meta[0], "y": y.getArray(), "yt": yt.getArray(),
                    "diag": A.getDiagonal().getArray(), "csr": A.getValuesCSR(),
                    "gathers": gathers, "stale": stale})
    return out


def interp_case(fshape, cshape, xc_global, xf_global, dtype="f64"):
    """MatInterpQ1MPI's mult and mult_t on this rank's slabs, gathered."""
    import torch
    from petsc_tpu_torch.dm.interp import MatInterpQ1MPI
    from petsc_tpu_torch.ops import operator
    from petsc_tpu_torch.parallel.layout import Layout
    _pt()
    comm = _comm()
    P, r = comm.nshards, comm.rank
    dt = torch.float64 if dtype == "f64" else torch.float32
    M = MatInterpQ1MPI(fshape, cshape, comm)
    op = operator.bind(M.meta, M.device_data())
    bc = Layout(int(np.prod(cshape)), P).block
    bf = Layout(int(np.prod(fshape)), P).block
    xc = torch.as_tensor(np.asarray(xc_global)[r * bc:(r + 1) * bc], dtype=dt)
    xf = torch.as_tensor(np.asarray(xf_global)[r * bf:(r + 1) * bf], dtype=dt)
    return {"P": comm.allgather(op.mult(xc)).numpy(), "R": comm.allgather(op.mult_t(xf)).numpy()}


def rap_case(n):
    """The sharded structured head's first probed level of the n^3 box27 on
    its grid: the coarse planes gathered as a host CSR, and its emax."""
    from petsc_tpu_torch.pc import gamg_device as gd
    ptt = _pt()
    comm = _comm()
    A = ptt.MatAIJ.from_scipy(box27(n), comm=comm)
    A.setStencilGrid((n,) * 3)
    meta, data = gd.device_rap_dnd_mpi(A.meta, A.device_data(), ((n + 1) // 2,) * 3, comm)
    Ac = gd.mpi_to_csr(meta, data)
    return {"Ac": (Ac.indptr, Ac.indices, Ac.data), "emax": gd.device_emax(A.meta,
                                                                          A.device_data()),
            "kind": meta[0], "nzl": meta[2]}


def dryrun_case(n):
    from petsc_tpu_torch.examples.dryrun_multichip import dryrun_multichip
    return dryrun_multichip(n, "cpu")


def dmda_case(n, args):
    """A DMDA on the multi-rank comm: createGlobalVector, createMatrix
    (the 7-point Laplacian by setValues), KSP.setDM and a solve."""
    ptt = _pt(args)
    comm = _comm()
    da = ptt.DMDA.create(3, (n, n, n), comm=comm)
    A = da.createMatrix()
    A_sp = laplace7(n)
    coo = A_sp.tocoo()
    A.setPreallocationCOO(coo.row, coo.col)
    A.setValuesCOO(coo.data)
    ksp = ptt.KSP().create()
    ksp.setDM(da)
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = da.createGlobalVector()
    b.setArray(A_sp @ np.ones(n ** 3))
    x = da.createGlobalVector()
    ksp.solve(b, x)
    return {"kind": A.meta[0], "its": ksp.getIterationNumber(),
            "reason": ksp.getConvergedReason().name, "x": x.getArray(),
            "local": b.getLocalSize(), "history": np.asarray(ksp.getConvergenceHistory())}


# ---------------------------------------------------------------------
# phase dist of chip_smoke.py, rehearsed at small size
# ---------------------------------------------------------------------

PLAINS = (("pallas_kernels", "triad_plain", "triad"),
          ("pallas_kernels", "axpy_normsq_plain", "axpy_normsq"),
          ("pallas_kernels", "dot2_plain", "dot2"),
          ("pallas_kernels", "csr_spmv_plain", "csr_spmv"),
          ("pallas_kernels", "cheby_update_plain", "cheby_update"),
          ("trisolve", "trisolve_sweep_plain", "trisolve"),
          ("grid_kernels", "dnd_stencil_plain", "dnd_stencil"),
          ("grid_kernels", "q1_prolong_plain", "q1_prolong"),
          ("grid_kernels", "q1_restrict_plain", "q1_restrict"),
          ("gather_kernels", "gather_plain", "gather"),
          ("pc_kernels", "dst_scatter_plain", "dst_scatter"))


def dist_phase_rehearsal(name, n, opts):
    """chip_smoke.dist_case on the CPU with every plain version counted as
    the card counts its kernel's launches: (the counts, the formula's
    counts, the record)."""
    import collections
    import importlib
    import chip_smoke
    counts = collections.Counter()
    saved = []
    for mod_name, fn, key in PLAINS:
        mod = importlib.import_module(f"petsc_tpu_torch.ops.{mod_name}")
        orig = getattr(mod, fn)

        def plain(*a, _f=orig, _k=key, **kw):
            counts[_k] += 1
            return _f(*a, **kw)
        saved.append((mod, fn, orig))
        setattr(mod, fn, plain)
    try:
        import petsc_tpu_torch as ptt
        _, kind, _ = chip_smoke.DIST_CASES[name]
        rec, _ = chip_smoke.dist_case(ptt, name, n, kind, opts, device="cpu", timing=False)
        got = {k: v for k, v in counts.items() if v}
        # the record's own counts are the card's (zero here)
        return got, rec["launches_needed"], {k: rec[k] for k in ("its", "reason", "levels",
                                                                  "A_kind", "true_relres")}
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)
