"""M1's plain version (CSR times a row-major block) and the plain layout
products of petsc_tpu_torch/ops/spmv.py against petsc_tpu on the CPU.

The same seeded numpy inputs go through the reference's functions
(``ell_spmm``, ``csr_seg_spmv_t``, ``dia_spmv``/``_t``, ``hyb_spmv``/``_t``,
``bdia_spmv``/``_t``, ``_onehot_select``, on jnp arrays) and the port's (on
torch tensors): the reference's results, not its TPU layouts (the port
stores CSR). M1's wrapper on a CPU tensor takes the plain version; it
counts no launch there. Tolerances: 1e-12 relative in float64 (the sums
run in another order), equal where a gather selects one value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsc_tpu.ops import spmv as rspmv
from petsc_tpu_torch.ops import pallas_kernels as pk
from petsc_tpu_torch.ops import spmv

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _csr(m, n, seed, long_row=True):
    """A random m x n CSR, row 1 longer than a warp (40 entries), rows 2
    and m - 1 empty."""
    A = sp.random(m, n, density=min(1.0, 6.0 / n), random_state=seed, format="lil")
    rng = np.random.default_rng(seed)
    if long_row:
        A[1, :] = 0
        A[1, rng.choice(n, min(40, n), replace=False)] = 1.0
    A[2, :] = 0
    A[m - 1, :] = 0
    A = A.tocsr()
    A.sort_indices()
    A.data = rng.standard_normal(A.nnz)
    return A


def _ell(A):
    """The reference's ELL of a CSR: (m, K) values and columns, padded
    with zeros."""
    m = A.shape[0]
    lens = np.diff(A.indptr)
    K = max(int(lens.max()), 1)
    data, idx = np.zeros((m, K)), np.zeros((m, K), dtype=np.int32)
    for i in range(m):
        lo, hi = A.indptr[i], A.indptr[i + 1]
        data[i, : hi - lo] = A.data[lo:hi]
        idx[i, : hi - lo] = A.indices[lo:hi]
    return data, idx


def _t(A):
    return (torch.as_tensor(A.indptr.astype(np.int64)), torch.as_tensor(A.indices.astype(np.int32)),
            torch.as_tensor(A.data))


@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_csr_spmm_equals_the_reference_ell_spmm(k):
    A = _csr(97, 83, seed=k)
    X = np.random.default_rng(10 + k).standard_normal((83, k))
    data, idx = _ell(A)
    want = np.asarray(rspmv.ell_spmm(jnp.asarray(data), jnp.asarray(idx), jnp.asarray(X)))
    pk.reset_launches()
    got = pk.csr_spmm(*_t(A), torch.as_tensor(X))
    assert pk.LAUNCHES["csr_spmm"] == 0          # the CPU takes the plain version
    assert got.shape == (97, k)
    assert _rel(got, want) <= TOL
    assert _rel(got, A @ X) <= TOL
    # the port's ELL form gives the same numbers
    assert _rel(spmv.ell_spmm(torch.as_tensor(data), torch.as_tensor(idx), torch.as_tensor(X)),
                want) <= TOL


def test_csr_spmm_equals_the_reference_maij_vmap():
    """The reference's MatMAIJ product (jax.vmap of the CSR product over the
    components) equals M1's plain version on the node-major block."""
    from petsc_tpu.ops import operator as rop
    import petsc_tpu as pt_jax
    A = _csr(64, 64, seed=3)
    pt_jax.init(args=["-mat_spmv_kind", "csr"])
    M = pt_jax.MatMAIJ.create(pt_jax.MatAIJ.from_scipy(A), 3)
    x = np.random.default_rng(4).standard_normal(64 * 3)
    want = np.asarray(rop.bind(M.meta, M.device_data()).mult(jnp.asarray(x)))
    got = pk.csr_spmm(*_t(A), torch.as_tensor(x.reshape(64, 3))).reshape(-1)
    assert _rel(got, want) <= TOL


def test_csr_spmm_checks_its_arguments():
    ip, col, vals = _t(_csr(10, 10, seed=1))
    with pytest.raises(ValueError):
        pk.csr_spmm(ip, col, vals, torch.zeros(10))                     # 1-D
    with pytest.raises(ValueError):
        pk.csr_spmm(ip, col, vals, torch.zeros((10, 4)).T)              # not contiguous
    with pytest.raises(TypeError):
        pk.csr_spmm(ip, col, vals, torch.zeros((10, 2), dtype=torch.float32))
    with pytest.raises(TypeError):
        pk.csr_spmm(ip.int(), col, vals, torch.zeros((10, 2), dtype=torch.float64))


@pytest.mark.parametrize("shape", [(50, 50), (40, 61), (61, 40)])
def test_csr_spmv_t_equals_the_reference_seg_spmv_t(shape):
    m, n = shape
    A = _csr(m, n, seed=m + n)
    x = np.random.default_rng(1).standard_normal(m)
    rows = np.repeat(np.arange(m), np.diff(A.indptr))
    want = np.asarray(rspmv.csr_seg_spmv_t(jnp.asarray(rows), jnp.asarray(A.indices),
                                           jnp.asarray(A.data), jnp.asarray(x), n))
    ip, col, vals = _t(A)
    assert _rel(spmv.csr_spmv_t(ip, col, vals, torch.as_tensor(x), n), want) <= TOL
    data, idx = _ell(A)
    assert _rel(spmv.ell_spmv_t(torch.as_tensor(data), torch.as_tensor(idx),
                                torch.as_tensor(x), n), want) <= TOL


def _dia(m, n, offsets, seed):
    """Random DIA data (K, m) with the entries that leave [0, n) zeroed,
    and the reference's pads."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), m))
    i = np.arange(m)
    for k, o in enumerate(offsets):
        data[k, (i + o < 0) | (i + o >= n)] = 0.0
    lpad = max(0, -min(offsets))
    rpad = max(0, max(offsets) + m - n)
    return data, lpad, rpad


@pytest.mark.parametrize("shape,offsets", [((60, 60), (-7, -1, 0, 1, 7)),
                                           ((48, 60), (-3, 0, 5, 12)),
                                           ((60, 48), (-12, -2, 0, 3))])
def test_dia_and_hyb_products_equal_the_reference(shape, offsets):
    m, n = shape
    data, lpad, rpad = _dia(m, n, offsets, seed=m)
    rng = np.random.default_rng(2)
    x, xt = rng.standard_normal(n), rng.standard_normal(m)
    j = jnp.asarray
    want = np.asarray(rspmv.dia_spmv(j(data), offsets, j(x), m, lpad, rpad))
    got = spmv.dia_spmv(torch.as_tensor(data), offsets, torch.as_tensor(x), m, lpad, rpad)
    assert _rel(got, want) <= TOL
    want_t = np.asarray(rspmv.dia_spmv_t(j(data), offsets, j(xt), n, m, lpad, rpad))
    got_t = spmv.dia_spmv_t(torch.as_tensor(data), offsets, torch.as_tensor(xt), n, m, lpad,
                            rpad)
    assert _rel(got_t, want_t) <= TOL
    # HYB: the same streams plus a spill of 9 COO entries
    srows, scols = rng.integers(0, m, 9), rng.integers(0, n, 9)
    sdata = rng.standard_normal(9)
    sidx = np.stack([srows, scols]).astype(np.int32)
    want = np.asarray(rspmv.hyb_spmv(j(data), offsets, j(sdata), j(sidx), j(x), m, lpad, rpad))
    got = spmv.hyb_spmv(torch.as_tensor(data), offsets, torch.as_tensor(sdata),
                        torch.as_tensor(sidx), torch.as_tensor(x), m, lpad, rpad)
    assert _rel(got, want) <= TOL
    want_t = np.asarray(rspmv.hyb_spmv_t(j(data), offsets, j(sdata), j(sidx), j(xt), n, m,
                                         lpad, rpad))
    got_t = spmv.hyb_spmv_t(torch.as_tensor(data), offsets, torch.as_tensor(sdata),
                            torch.as_tensor(sidx), torch.as_tensor(xt), n, m, lpad, rpad)
    assert _rel(got_t, want_t) <= TOL


def test_onehot_select_equals_the_reference():
    rng = np.random.default_rng(3)
    V = rng.standard_normal((5, 1, 128))
    lanes = rng.integers(0, 128, (5, 128, 4)).astype(np.int32)
    want = np.asarray(rspmv._onehot_select(jnp.asarray(V), jnp.asarray(lanes)))
    got = spmv._onehot_select(torch.as_tensor(V), torch.as_tensor(lanes))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("spill", [False, True])
def test_bdia_products_equal_the_reference(spill):
    rng = np.random.default_rng(4)
    m = n = 300                      # G = 3 groups of 128 rows
    G, K = 3, 4
    joffs = np.array([-1, 0, 1], dtype=np.int32)
    data = rng.standard_normal((3, G * 128, K))
    data[:, m:] = 0.0                # rows past m hold nothing
    lanes = rng.integers(0, 128, (3, G * 128, K)).astype(np.int32)
    # no entry may leave [0, m): zero the ones that would
    r = np.arange(G * 128)[:, None]
    for b, jv in enumerate(joffs):
        c = 128 * (r // 128 + jv) + lanes[b]
        data[b][(c < 0) | (c >= m)] = 0.0
    x, xt = rng.standard_normal(n), rng.standard_normal(m)
    sp_j = sp_t = None
    if spill:
        s = (rng.integers(0, m, 7).astype(np.int32), rng.integers(0, n, 7).astype(np.int32),
             rng.standard_normal(7))
        sp_j = tuple(jnp.asarray(a) for a in s)
        sp_t = tuple(torch.as_tensor(a) for a in s)
    j = jnp.asarray
    want = np.asarray(rspmv.bdia_spmv(j(joffs), -1, 1, j(data), j(lanes), sp_j, j(x), m))
    got = spmv.bdia_spmv(torch.as_tensor(joffs), -1, 1, torch.as_tensor(data),
                         torch.as_tensor(lanes), sp_t, torch.as_tensor(x), m)
    assert _rel(got, want) <= TOL
    want_t = np.asarray(rspmv.bdia_spmv_t(j(joffs), -1, 1, j(data), j(lanes), sp_j, j(xt), m,
                                          n))
    got_t = spmv.bdia_spmv_t(torch.as_tensor(joffs), -1, 1, torch.as_tensor(data),
                             torch.as_tensor(lanes), sp_t, torch.as_tensor(xt), m, n)
    assert _rel(got_t, want_t) <= TOL


def test_the_reference_hyb_layout_results_from_csr():
    """tests/test_hyb_layout.py on results: a near-stencil matrix the
    reference stores as HYB (DIA streams plus a spill) gives the same
    product, transpose product (the port's on the explicit transpose), and
    both again after new values on the same pattern."""
    import petsc_tpu as pt_jax
    import petsc_tpu_torch as ptt
    from tests.test_hyb_layout import near_stencil
    A = near_stencil()
    pt_jax.init()
    ptt.init(device="cpu")
    Mj, Mp = pt_jax.MatAIJ.from_scipy(A), ptt.MatAIJ.from_scipy(A)
    assert Mj.meta[0] == "aij_hyb" and Mp.meta[0] == "aij_csr"
    rng = np.random.default_rng(8)
    x = rng.standard_normal(A.shape[0])
    for step in range(2):
        if step:
            A2 = A.copy()
            A2.data = A2.data * 1.7 + 0.01
            for M in (Mj, Mp):
                M.setValuesCSR(A2.indptr, A2.indices, A2.data)
                M.assemble()
            A = A2
        for transpose, want in ((False, A @ x), (True, A.T @ x)):
            got = []
            for pkg, M in ((pt_jax, Mj), (ptt, Mp)):
                y = M.createVecRight() if transpose else M.createVecLeft()
                (M.multTranspose if transpose else M.mult)(pkg.Vec.from_array(x), y)
                got.append(np.asarray(y.getArray())[: A.shape[0]])
            assert _rel(got[1], want) <= TOL and _rel(got[1], got[0]) <= TOL
