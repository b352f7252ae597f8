"""The block layout of petsc_tpu_torch's MatAIJ (bs > 1) against petsc_tpu:
the BSR build against the reference's block-ELL (``aij_bell``), the
products (B1's plain version on the CPU) against ``_bind_aij_bell`` and,
on a declared grid, the reference's no-gather block stencil
(``aij_dndb``), COO assembly on a block matrix, ``setBlockSize`` after
``from_scipy``, and ``MatNullSpace.createRigidBody``.

Tolerances: the layouts hold the same numbers (equal); products to 1e-12
relative (the reference's einsum sums each block in another order); B1's
plain version equals a float64 dense product to 1e-13; rigid-body modes
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch.ops import block_kernels as bk

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

BS = (2, 3, 6)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _block_matrix(nb, bs, seed=0, density=0.3):
    """A random matrix of nb x nb dense bs x bs blocks (the diagonal ones
    included) with one empty block row."""
    rng = np.random.default_rng(seed)
    B = sp.random(nb, nb, density=density, random_state=seed, format="csr") + sp.eye(nb)
    B = B.tolil()
    B[nb // 2, :] = 0
    B = B.tocsr()
    B.eliminate_zeros()
    A = sp.kron(B, np.ones((bs, bs)), format="csr")
    A.data = rng.standard_normal(A.nnz)
    A.sort_indices()
    return A


def _init_pkg(pkg):
    if pkg is ptt:
        ptt.init(device="cpu")
    else:
        pt_jax.init()


def _both(A, bs, args=()):
    ptt.init(args=list(args), device="cpu")
    M = ptt.MatAIJ.from_scipy(A)
    M.setBlockSize(bs)
    pt_jax.init(args=list(args))
    Mj = pt_jax.MatAIJ.from_scipy(A)
    Mj.setBlockSize(bs)
    return M, Mj


@pytest.mark.parametrize("bs", BS)
def test_bsr_build_and_products_match_bell(bs):
    A = _block_matrix(13, bs)
    M, Mj = _both(A, bs)
    assert M.meta == ("aij_bsr", 13 * bs, 13 * bs, bs)
    assert Mj.meta[0] == "aij_bell"
    d, dj = M.device_data(), Mj.device_data()
    # the same blocks: the reference's rows padded to Kb blocks
    lens = np.diff(d["bptr"].numpy())
    bidx, bdata = np.asarray(dj["bidx"]), np.asarray(dj["bdata"])
    for i, L in enumerate(lens):
        lo = d["bptr"][i].item()
        assert np.array_equal(d["bcol"][lo:lo + L].numpy(), bidx[i, :L])
        assert np.array_equal(d["bvals"][lo:lo + L].numpy(), bdata[i, :L])
        assert not bdata[i, L:].any()
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    op, opj = M.op(), Mj.op()
    assert _rel(op.mult(torch.from_numpy(x)).numpy(), np.asarray(opj.mult(jnp.asarray(x)))) \
        <= 1e-12
    assert _rel(op.mult_t(torch.from_numpy(x)).numpy(),
                np.asarray(opj.mult_t(jnp.asarray(x)))) <= 1e-12
    assert np.array_equal(op.diag().numpy(), np.asarray(opj.diag()))
    assert _rel(op.mult(torch.from_numpy(x)).numpy(), A @ x) <= 1e-13


@pytest.mark.parametrize("bs", BS)
def test_bsr_plain_product_on_ragged_rows(bs):
    """B1's plain version: a row of 500 blocks, an empty row, rows of one
    block, against a float64 dense product."""
    rng = np.random.default_rng(bs)
    nbr = 600
    lens = rng.integers(1, 4, nbr)
    lens[7], lens[8] = 500, 0
    bcol = np.concatenate([np.sort(rng.choice(nbr, size=L, replace=False)) for L in lens])
    ptr = np.concatenate([[0], np.cumsum(lens)])
    vals = rng.standard_normal((len(bcol), bs, bs))
    x = rng.standard_normal(nbr * bs)
    y = bk.bsr_spmv(torch.as_tensor(ptr), torch.as_tensor(bcol.astype(np.int32)),
                    torch.as_tensor(vals), torch.as_tensor(x)).numpy()
    A = sp.bsr_matrix((vals, bcol, ptr), shape=(nbr * bs, nbr * bs))
    assert _rel(y, A @ x) <= 1e-13
    assert not y[8 * bs:9 * bs].any()


@pytest.mark.parametrize("bs", (2, 3))
def test_declared_grid_gives_the_dndb_results(bs):
    """A vector-field stencil on a declared grid: the reference lays it as
    its no-gather block stencil (aij_dndb); the port keeps BSR and gives
    the same products and diagonal."""
    n = 6
    rng = np.random.default_rng(bs)
    L = sp.diags([4.0 * np.ones(n * n), -np.ones(n * n - 1), -np.ones(n * n - 1),
                  -np.ones(n * n - n), -np.ones(n * n - n)], [0, 1, -1, n, -n], format="csr")
    A = sp.kron(L, rng.standard_normal((bs, bs)) + 3 * np.eye(bs), format="csr")
    A.data = A.data * (1 + 0.1 * rng.standard_normal(A.nnz))
    A.sort_indices()
    ptt.init(device="cpu")
    M = ptt.MatAIJ.from_scipy(A)
    M.setStencilGrid((n, n))
    M.setBlockSize(bs)
    pt_jax.init()
    Mj = pt_jax.MatAIJ.from_scipy(A)
    Mj.setStencilGrid((n, n))
    Mj.setBlockSize(bs)
    assert Mj.meta[0] == "aij_dndb" and M.meta[0] == "aij_bsr"
    x = rng.standard_normal(A.shape[0])
    op, opj = M.op(), Mj.op()
    assert _rel(op.mult(torch.from_numpy(x)).numpy(), np.asarray(opj.mult(jnp.asarray(x)))) \
        <= 1e-12
    assert _rel(op.mult_t(torch.from_numpy(x)).numpy(),
                np.asarray(opj.mult_t(jnp.asarray(x)))) <= 1e-12
    assert np.array_equal(op.diag().numpy(), np.asarray(opj.diag()))


@pytest.mark.parametrize("kind", ("bell", "dndb"))
def test_block_kinds_by_option(kind):
    """-mat_spmv_kind bell and dndb take the BSR layout (bs 1 included);
    unequal row and column block sizes are refused."""
    A = _block_matrix(9, 1, seed=4)
    ptt.init(args=["-mat_spmv_kind", kind], device="cpu")
    M = ptt.MatAIJ.from_scipy(A)
    x = np.random.default_rng(2).standard_normal(9)
    assert M.meta[0] == "aij_bsr" and M.meta[3] == 1
    assert _rel(M.op().mult(torch.from_numpy(x)).numpy(), A @ x) <= 1e-13
    R = ptt.MatAIJ()
    R.setSizes((6, 6))
    R.row_layout = R.row_layout.__class__(6, bs=2)
    with pytest.raises(ptt.Error, match="block size"):
        R.assemble()


@pytest.mark.parametrize("dup", (False, True))
def test_coo_values_on_a_block_matrix(dup):
    """setPreallocationCOO / setValuesCOO with bs 3 (the entries filling
    every block slot once: one gather into the blocks; with repeated
    entries: the CSR sum scattered into them), two value sets, against
    the reference's COO path."""
    bs = 3
    A = _block_matrix(8, bs, seed=7)
    coo = A.tocoo()
    i, j = coo.row.astype(np.int64), coo.col.astype(np.int64)
    rng = np.random.default_rng(8)
    order = rng.permutation(len(i))
    i, j = i[order], j[order]
    if dup:
        i, j = np.concatenate([i, i[:40]]), np.concatenate([j, j[:40]])
    x = rng.standard_normal(A.shape[0])
    mats = {}
    for pkg in (ptt, pt_jax):
        _init_pkg(pkg)
        M = pkg.MatAIJ()
        M.setSizes(A.shape[0], bs=bs)
        M.setPreallocationCOO(i, j)
        mats[pkg] = M
    for _ in range(2):
        v = rng.standard_normal(len(i))
        outs = []
        for pkg, M in mats.items():
            _init_pkg(pkg)
            M.setValuesCOO(v)
            op = M.op()
            xx = torch.from_numpy(x) if pkg is ptt else jnp.asarray(x)
            outs.append((M.meta[0], np.asarray(op.mult(xx)), np.asarray(op.diag()),
                         M.to_scipy().toarray()))
        (k, y, dg, Ad), (kj, yj, dgj, Adj) = outs
        assert k == "aij_bsr" and kj == "aij_bell"
        assert _rel(y, yj) <= 1e-12 and np.array_equal(dg, dgj) and np.array_equal(Ad, Adj)


def test_set_block_size_after_from_scipy_relays_the_device_copy():
    A = _block_matrix(10, 3, seed=5)
    ptt.init(device="cpu")
    M = ptt.MatAIJ.from_scipy(A)
    assert M.meta[0] == "aij_csr" and M.getBlockSize() == 1
    s0 = M.state
    M.setBlockSize(3)
    assert M.meta[0] == "aij_bsr" and M.getBlockSize() == 3 and M.state > s0
    dev = M.device_data()
    assert "vals" not in dev and "col" not in dev and "indptr" not in dev   # no CSR copy kept
    x = np.random.default_rng(6).standard_normal(30)
    assert _rel(M.op().mult(torch.from_numpy(x)).numpy(), A @ x) <= 1e-13
    assert np.array_equal(M.to_scipy().toarray(), A.toarray())
    M.setBlockSize(1)
    assert M.meta[0] == "aij_csr" and "bvals" not in M.device_data()


@pytest.mark.parametrize("dim", (2, 3))
def test_create_rigid_body_matches_jax(dim):
    coords = np.random.default_rng(dim).random((17, dim))
    ns = ptt.MatNullSpace.createRigidBody(coords)
    nsj = pt_jax.MatNullSpace.createRigidBody(coords)
    assert np.array_equal(ns.dense_or(17 * dim), nsj.dense_or(17 * dim))
    assert ns.vectors == [] and not ns.has_constant
    plain = ptt.MatNullSpace(constant=True, vectors=[np.arange(4.0)])
    plainj = pt_jax.MatNullSpace(constant=True, vectors=[np.arange(4.0)])
    assert np.array_equal(plain.dense_or(4), plainj.dense_or(4))


def _ragged_bsr(nbr, bs, seed, long_row=None, empty_row=None):
    """A random BSR on the host: rows of 1 to 7 blocks, a row of long_row[1]
    blocks and an empty row where asked; (indptr, bcol, vals, x)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 8, nbr)
    if long_row is not None:
        lens[long_row[0]] = long_row[1]
    if empty_row is not None:
        lens[empty_row] = 0
    bcol = np.concatenate([np.sort(rng.choice(nbr, size=L, replace=False)) for L in lens])
    ptr = np.concatenate([[0], np.cumsum(lens)])
    return ptr, bcol.astype(np.int32), rng.standard_normal((len(bcol), bs, bs)), \
        rng.standard_normal(nbr * bs)


@pytest.mark.parametrize("grid", (1, 7, 64))
@pytest.mark.parametrize("bs", (2, 3, 5))
def test_bsr_plan_owns_each_row_once(bs, grid):
    """B1's plan: chunk edges at the multiples of the chunk, every block row
    owned by one thread block, the rows a block owns starting in its run of
    chunks (the last also owns the trailing empty rows), its chunks covering
    its rows' blocks in order; a row of 2,000 blocks crosses chunk edges."""
    ptr, *_ = _ragged_bsr(3000, bs, bs, long_row=(400, 2000), empty_row=17)
    ptr = np.concatenate([ptr, [ptr[-1]] * 3])           # trailing empty rows
    plan = bk.bsr_plan(ptr, bs, grid)
    C = plan["chunk"]
    assert C == bk.bsr_chunk(bs)
    mb = len(ptr) - 1
    owned = [r for lo, hi in plan["rows"] for r in range(lo, hi)]
    assert owned == list(range(mb))
    crossing = 0
    for (t0, t1), (lo, hi), chunks in zip(plan["runs"], plan["rows"], plan["chunks"]):
        for r in range(lo, hi):
            assert t0 * C <= ptr[r] < t1 * C or (hi == mb and ptr[r] == ptr[-1])
        assert chunks[0][0] == ptr[lo] and chunks[-1][1] == ptr[hi]
        for (a, b), (c, _) in zip(chunks, chunks[1:]):
            assert b == c and b % C == 0 and a < b
        edges = {b for _, b in chunks[:-1]}
        crossing += sum(ptr[r] < e < ptr[r + 1] for r in range(lo, hi) for e in edges)
    assert crossing > 0 and sum(ptr[400] < b < ptr[401] for ch in plan["chunks"]
                                for _, b in ch) >= 2


@pytest.mark.parametrize("grid", (1, 7, 64))
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("bs", (2, 3, 5))
def test_bsr_chunked_order_equals_plain_bits(bs, dtype, grid):
    """B1's arithmetic along its plan, in numpy: each chunk's inner sums,
    then each output's running sum carried from chunk to chunk (not a
    partial sum added to a carry), gives the plain version's bits."""
    ptr, bcol, vals, x = _ragged_bsr(700, bs, 10 + bs, long_row=(3, 500), empty_row=9)
    vals, x = vals.astype(dtype), x.astype(dtype)
    plan = bk.bsr_plan(ptr, bs, grid)
    y = np.full(len(x), np.nan, dtype=dtype)
    for (lo, hi), chunks in zip(plan["rows"], plan["chunks"]):
        acc = {}
        for a, b in chunks:
            xs = x.reshape(-1, bs)[bcol[a:b]]                        # (blocks, c)
            s = vals[a:b, :, 0] * xs[:, None, 0]
            for c in range(1, bs):
                s = s + vals[a:b, :, c] * xs[:, None, c]
            for r in range(lo, hi):
                k0, k1 = max(ptr[r], a), min(ptr[r + 1], b)
                if k0 >= k1 and not (ptr[r] == ptr[r + 1] and a <= ptr[r] <= b):
                    continue
                run = acc.get(r, np.zeros(bs, dtype=dtype))
                for k in range(k0, k1):
                    run = run + s[k - a]
                acc[r] = run
                if ptr[r + 1] <= b:
                    y[r * bs:(r + 1) * bs] = run
    want = bk.bsr_spmv_plain(torch.as_tensor(ptr), torch.as_tensor(bcol),
                             torch.as_tensor(vals), torch.as_tensor(x)).numpy()
    assert np.array_equal(y, want)
    assert not y[9 * bs:10 * bs].any()
