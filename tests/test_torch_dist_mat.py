"""The distributed matrices of the port against the JAX package: the
host set-up (ShardedCSR, the distributed aggregation) in this process, in
bits; the mpiaij and dnd_mpi products, the slab Q1 transfer and the
sharded head's probed level on 4 gloo ranks (one torch thread each,
tests/dist_parity.py) against the reference on 4 of conftest's virtual
devices, to 1e-12 relative (the products sum each row in another order
than XLA's fused loops).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp

import petsc_tpu as pt_jax
from petsc_tpu.dm.interp import MatInterpQ1MPI as RQ1MPI
from petsc_tpu.mat.shardcsr import ShardedCSR as RSharded
from petsc_tpu.ops import operator as rop
from petsc_tpu.parallel.layout import Layout as RLayout
from petsc_tpu.parallel.mesh import make_comm as rmake_comm
from petsc_tpu.pc import gamg_device as rgd
from petsc_tpu.pc import gamg_dist as rgdist
from petsc_tpu_torch.mat.shardcsr import ShardedCSR
from petsc_tpu_torch.parallel.layout import Layout
from petsc_tpu_torch.pc import gamg_dist

import dist_cases
from dist_parity import shared_pool

P = 4
PROD_RTOL = 1e-12       # row sums in another order than XLA's


@pytest.fixture(scope="module")
def pool():
    return shared_pool(P)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _csr_equal(A, B):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    A.sort_indices()
    B.sort_indices()
    return (A.shape == B.shape and np.array_equal(A.indptr, B.indptr)
            and np.array_equal(A.indices, B.indices) and np.array_equal(A.data, B.data))


# ---------------- host set-up, in bits ----------------

def test_layout_equals_the_reference():
    for N, nsh, pad_to in ((37, 4, 1), (64, 8, 1), (100, 3, 8), (5, 8, 1)):
        a, b = Layout(N, nsh, pad_to=pad_to), RLayout(N, nshards=nsh, pad_to=pad_to)
        assert (a.block, a.Npad, a.pad) == (b.block, b.Npad, b.pad)
        assert all(a.range(s) == b.range(s) for s in range(nsh))
        assert np.array_equal(a.owner(np.arange(a.Npad)), b.owner(np.arange(b.Npad)))


def test_sharded_csr_operations_equal_the_reference_in_bits():
    A = dist_cases.box27(6)
    rng = np.random.default_rng(2)
    Pm = sp.random(A.shape[0], 40, density=0.05, random_state=3, format="csr")
    S, R = ShardedCSR.from_global_csr(A, P), RSharded.from_global_csr(A, P)
    SP, RP = ShardedCSR.from_global_csr(Pm, P), RSharded.from_global_csr(Pm, P)
    rows = np.sort(rng.choice(A.shape[0], 30, replace=False))
    assert _csr_equal(S.fetch_rows(rows), R.fetch_rows(rows))
    sub = rng.permutation(A.shape[0])[:50]
    a, b = S.submatrix(sub, sub[::-1]), R.submatrix(sub, sub[::-1])
    assert all(_csr_equal(x, y) for x, y in zip(a.blocks, b.blocks))
    assert all(np.array_equal(x, y) for x, y in zip(S.diag_shards(), R.diag_shards()))
    assert all(_csr_equal(x, y) for x, y in zip(S.transpose().blocks, R.transpose().blocks))
    assert all(_csr_equal(x, y) for x, y in zip(S.spmm(SP).blocks, R.spmm(RP).blocks))
    assert all(_csr_equal(x, y) for x, y in zip(S.ptap(SP).blocks, R.ptap(RP).blocks))
    x = rng.standard_normal(S.col_layout.Npad)
    assert np.array_equal(S.matvec(x), R.matvec(x))
    assert _csr_equal(S.to_global_csr(), R.to_global_csr())


@pytest.mark.parametrize("aggressive", [False, True])
def test_distributed_aggregation_equals_the_reference_in_bits(aggressive):
    """gamg_dist's level (MIS rounds, aggregates, tentative and smoothed P,
    Galerkin product, emax) on the 10^3 box27 over 4 shards."""
    A = dist_cases.box27(10)
    S, R = ShardedCSR.from_global_csr(A, P), RSharded.from_global_csr(A, P)
    b = S.row_layout.valid_mask_np.astype(np.float64)
    got = gamg_dist.build_level(S, b, -1.0, aggressive, 1)
    want = rgdist.build_level(R, b, -1.0, aggressive, 1)
    assert got[3] == want[3] and got[4] == want[4]
    assert np.array_equal(got[2], want[2])
    for x, y in zip(got[0].blocks + got[1].blocks, want[0].blocks + want[1].blocks):
        assert _csr_equal(x, y)
    G = gamg_dist.dist_strength_graph(S)
    ar, st = gamg_dist.dist_mis_aggregate(G)
    ar2, st2 = rgdist.dist_mis_aggregate(rgdist.dist_strength_graph(R))
    assert np.array_equal(ar, ar2) and np.array_equal(st, st2)


# ---------------- products on the ranks ----------------

def _np_tree(d):
    if isinstance(d, dict):
        return {k: _np_tree(v) for k, v in d.items()}
    return np.asarray(d)


def _ref_products(A_sp, grid=None):
    comm = rmake_comm(P)
    A = pt_jax.MatAIJ.from_scipy(A_sp, comm=comm)
    if grid is not None:
        A.setStencilGrid(grid)
    op = rop.bind(A.meta, A.device_data())
    rng = np.random.default_rng(7)
    npad = A.col_layout.Npad
    x = np.zeros(npad)
    x[: A_sp.shape[1]] = rng.standard_normal(A_sp.shape[1])
    y = np.asarray(jax.jit(op.mult)(jnp.asarray(x)))[: A_sp.shape[0]]   # one compile
    meta = tuple(A.meta[:8]) if A.meta[0] == "mpiaij" else tuple(A.meta[:6])
    return A.meta[0], meta, _np_tree(A.device_data()), x, y


@pytest.mark.parametrize("case", ["poisson2d_16", "laplace7_8_grid", "rect"])
def test_distributed_products_equal_the_reference(pool, case):
    """mpiaij and dnd_mpi mult (against the reference's product) and mult_t
    (against the transpose's product on the host), the operator carried
    from the reference's (meta, data) (interop) and built from the CSR."""
    pt_jax.init(args=[])
    grid = None
    if case == "poisson2d_16":
        A_sp = dist_cases.poisson2d(16)
    elif case == "rect":
        A_sp = sp.random(50, 37, density=0.1, random_state=5, format="csr")
    else:
        A_sp = dist_cases.laplace7(8)
        grid = (8, 8, 8)
    kind, meta, data, x, y = _ref_products(A_sp, grid)
    # A^T x: the reference's mult_t computes the same transpose product
    yt = A_sp.T @ x[: A_sp.shape[0]] if A_sp.shape[0] == A_sp.shape[1] else None
    assert kind == ("dnd_mpi" if grid else "mpiaij")
    csr = (A_sp.indptr, A_sp.indices, A_sp.data)
    for g in pool.run("mult_case", meta, data, A_sp.shape, x, grid, csr):
        for name in ("interop", "csr"):
            assert g[name]["kind"] == kind
            assert _rel(g[name]["y"], y) <= PROD_RTOL, name
            assert _rel(g[name]["y"], A_sp @ x[: A_sp.shape[1]]) <= PROD_RTOL
            if yt is not None:
                assert _rel(g[name]["yt"], yt) <= PROD_RTOL, name
            if A_sp.shape[0] == A_sp.shape[1]:
                assert np.array_equal(g[name]["diag"], A_sp.diagonal())


@pytest.mark.parametrize("case", ["mpiaij", "dnd_mpi"])
def test_coo_values_on_the_ranks_stay_on_the_device(pool, case):
    """setValuesCOO on 4 ranks, with repeated and negative (dropped)
    entries: each rank sums its own rows' values on its device (K8 and the
    segmented sum, then K8 into mpiaij's two blocks, or a scatter into the
    slab's planes), twice on one pattern. The values are multiples of 1/8,
    so every sum of repeats is exact and the host CSR read back from the
    ranks equals scipy's sum of the triplets in bits; the products match
    scipy's to 1e-12. (The reference's setValuesCOO refuses both sharded
    layouts, "COO numeric update unsupported", so scipy is the reference
    here; the layouts' products are held to the reference's above.)"""
    rng = np.random.default_rng(3)
    if case == "mpiaij":
        B = sp.random(50, 50, density=0.1, random_state=5, format="coo") + sp.eye(50)
        grid = None
    else:
        B, grid = dist_cases.laplace7(8).tocoo(), (8, 8, 8)
    B = B.tocoo()
    n = B.shape[0]
    # every entry twice, a fifth three times, and two dropped (negative i or j)
    extra = rng.choice(B.nnz, B.nnz // 5, replace=False)
    ci = np.concatenate([B.row, B.row, B.row[extra], [-1, 3]])
    cj = np.concatenate([B.col, B.col, B.col[extra], [4, -2]])
    sets = [rng.integers(-64, 65, len(ci)) / 8.0 for _ in range(2)]
    x = rng.standard_normal(n)
    keep = (ci >= 0) & (cj >= 0)
    wants = []
    for v in sets:
        A_sp = sp.csr_matrix((v[keep], (ci[keep], cj[keep])), shape=B.shape)
        A_sp.sum_duplicates()
        wants.append(A_sp)
    for g in pool.run("coo_case", ci, cj, sets, B.shape, x, grid):
        for out, A_sp in zip(g, wants):
            assert out["kind"] == case
            assert out["stale"] and out["gathers"] >= 1
            assert _rel(out["y"], A_sp @ x) <= PROD_RTOL
            assert _rel(out["yt"], A_sp.T @ x) <= PROD_RTOL
            assert np.array_equal(out["diag"], A_sp.diagonal())
            ip, ix, vals = out["csr"]
            assert np.array_equal(ip, A_sp.indptr) and np.array_equal(ix, A_sp.indices)
            assert np.array_equal(vals, A_sp.data)


@pytest.mark.parametrize("fshape, cshape", [((16, 8, 6), (8, 4, 3)), ((8, 9), (4, 5))])
def test_slab_q1_transfer_equals_the_reference(pool, fshape, cshape):
    """Q1P and Q1R on the slabs, in f64 and f32, against the reference's
    (float64) transfer."""
    pt_jax.init(args=[])
    comm = rmake_comm(P)
    op = rop.bind(RQ1MPI(fshape, cshape, comm).meta, {})
    rng = np.random.default_rng(1)
    nc, nf = int(np.prod(cshape)), int(np.prod(fshape))
    xc, xf = rng.standard_normal(nc), rng.standard_normal(nf)
    wp = np.asarray(jax.jit(op.mult)(jnp.asarray(xc)))[:nf]      # one compile each
    wr = np.asarray(jax.jit(op.mult_t)(jnp.asarray(xf)))[:nc]
    for dtype, tol in (("f64", PROD_RTOL), ("f32", 1e-6)):      # f32: its rounding
        for g in pool.run("interp_case", fshape, cshape, xc, xf, dtype):
            assert _rel(g["P"][:nf], wp) <= tol and _rel(g["R"][:nc], wr) <= tol


def test_the_sharded_head_probes_the_reference_level(pool):
    """The first probed level of the 16^3 box27 on its slab grid (planes
    gathered to a host CSR) and the fine level's Lanczos bound."""
    pt_jax.init(args=[])
    comm = rmake_comm(P)
    A = pt_jax.MatAIJ.from_scipy(dist_cases.box27(16), comm=comm)
    A.setStencilGrid((16, 16, 16))
    meta, data = rgd.device_rap_dnd_mpi(A.meta, A.device_data(), (8, 8, 8), comm)
    want = rgd.mpi_to_csr(meta, data)
    emax = rgd.device_emax(A.meta, A.device_data())
    for g in pool.run("rap_case", 16):
        assert g["kind"] == "dnd_mpi" and g["nzl"] == 8 // P
        Ac = sp.csr_matrix((g["Ac"][2], g["Ac"][1], g["Ac"][0]), shape=want.shape)
        assert _rel(Ac.toarray(), want.toarray()) <= PROD_RTOL
        assert abs(g["emax"] - emax) <= 1e-10 * emax
