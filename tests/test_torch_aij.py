"""petsc_tpu_torch's assembled MatAIJ against petsc_tpu's, on the CPU.

Both packages assemble the same matrices through the same calls (setValues
with ADD and INSERT, setValuesCSR, COO with a numeric refresh), then the
products, the host matrix operations, the layout options and the interop
with the reference's state are compared.

Tolerances: assembled matrices are equal exactly (the same sums in the
same order); products agree to 1e-12 relative in float64 (the sums run in
another order) and 1e-5 in float32; the host matrix operations to 1e-14
(both are scipy on the host)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu.mat import mmio as mmio_jax
from petsc_tpu.ops import spmv as spmv_jax
from petsc_tpu_torch import interop
from petsc_tpu_torch.mat import mmio
from petsc_tpu_torch.ops import pallas_kernels as pk
from petsc_tpu_torch.ops import spmv

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = ("LFAT5.mtx", "m_05_05_crk.mtx", "amesos2_test_mat0.mtx")


def _init_both(*args):
    pt_jax.init(args=list(args))
    ptt.init(args=list(args), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    den = np.max(np.abs(b)) if b.size else 0.0
    return float(np.max(np.abs(a - b)) / den) if b.size and den > 0 else \
        float(np.max(np.abs(a - b), initial=0.0))


def _same_csr(Mp, Mj):
    a, b = Mp.to_scipy(), Mj.to_scipy()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


def _rand(m, n, seed, density=0.3):
    return sp.random(m, n, density=density, random_state=np.random.RandomState(seed),
                     format="csr")


def _matrices():
    mats = {f"rand_{m}x{n}": _rand(m, n, seed) for seed, (m, n) in
            enumerate(((7, 5), (40, 60), (60, 40)))}
    for f in FIXTURES:
        mats[f] = sp.csr_matrix(scipy.io.mmread(DATA / f))
    return mats


# ------------------------------------------------------------------ assembly

def _ex2(pkg, m, n, mode):
    A = pkg.MatAIJ()
    A.setSizes((m * n, m * n))
    for Ii in range(m * n):
        i, j = Ii // n, Ii % n
        if i > 0:
            A.setValue(Ii, Ii - n, -1.0, mode)
        if i < m - 1:
            A.setValue(Ii, Ii + n, -1.0, mode)
        if j > 0:
            A.setValue(Ii, Ii - 1, -1.0, mode)
        if j < n - 1:
            A.setValue(Ii, Ii + 1, -1.0, mode)
        A.setValue(Ii, Ii, 4.0, mode)
        if mode == pkg.InsertMode.INSERT_VALUES:
            A.setValue(Ii, Ii, 4.5, mode)          # the last value wins
    A.assemblyBegin()
    A.assemblyEnd()
    return A


@pytest.mark.parametrize("mode", ("ADD_VALUES", "INSERT_VALUES"))
def test_setvalues_ex2_matches_jax(mode):
    _init_both()
    Mp = _ex2(ptt, 4, 3, getattr(ptt.InsertMode, mode))
    Mj = _ex2(pt_jax, 4, 3, getattr(pt_jax.InsertMode, mode))
    _same_csr(Mp, Mj)
    assert Mp.nnz() == Mj.nnz() == 12 * 5 - 2 * 4 - 2 * 3
    assert Mp.meta == ("aij_csr", 12, 12)


def _random_blocks(pkg, mode, seed, rounds):
    rng = np.random.default_rng(seed)
    A = pkg.MatAIJ()
    A.setSizes((9, 11))
    for _ in range(rounds):
        for _ in range(6):
            rows = rng.integers(-1, 9, 3)
            cols = rng.integers(-1, 11, 4)
            A.setValues(rows, cols, rng.random((3, 4)) - 0.5, mode)
        A.assemble()          # a second round merges into the existing CSR
    return A


@pytest.mark.parametrize("rounds", (1, 2))
@pytest.mark.parametrize("mode", ("ADD_VALUES", "INSERT_VALUES"))
def test_setvalues_random_blocks_with_negative_indices_match_jax(mode, rounds):
    _init_both()
    Mp = _random_blocks(ptt, getattr(ptt.InsertMode, mode), 3, rounds)
    Mj = _random_blocks(pt_jax, getattr(pt_jax.InsertMode, mode), 3, rounds)
    _same_csr(Mp, Mj)
    for r in range(9):
        for a, b in zip(Mp.getRow(r), Mj.getRow(r)):
            assert np.array_equal(a, b)


def test_setvaluescsr_unsorted_rows_match_jax():
    A = _rand(20, 15, 7)
    rng = np.random.default_rng(0)
    indices, data = A.indices.copy(), A.data.copy()
    for r in range(20):          # shuffle the columns within every row
        lo, hi = A.indptr[r], A.indptr[r + 1]
        p = lo + rng.permutation(hi - lo)
        indices[lo:hi], data[lo:hi] = indices[p], data[p]
    _init_both()
    Ms = []
    for pkg in (ptt, pt_jax):
        M = pkg.MatAIJ()
        M.setSizes((20, 15))
        M.setValuesCSR(A.indptr, indices, data)
        Ms.append(M.assemble())
    _same_csr(*Ms)
    assert (Ms[0].to_scipy() != A).nnz == 0
    for a, b in zip(Ms[0].getValuesCSR(), Ms[1].getValuesCSR()):
        assert np.array_equal(a, b)
    assert Ms[0].getInfo() == Ms[1].getInfo()


def _coo_case(seed):
    """A 30 x 30 pattern in shuffled order, with duplicates (some entries
    split in two or three parts) and entries with negative indices."""
    rng = np.random.default_rng(seed)
    A = (_rand(30, 30, seed, 0.15) + sp.eye(30)).tocoo()
    i, j, v = [A.row], [A.col], [A.data]
    k = rng.choice(A.nnz, 40, replace=False)
    i += [A.row[k], A.row[k[:10]]]
    j += [A.col[k], A.col[k[:10]]]
    v += [rng.random(40), rng.random(10)]
    i.append(np.array([-1, 3, -1, 5]))
    j.append(np.array([2, -1, -1, 7]))
    v.append(np.array([9.0, 9.0, 9.0, 1.25]))
    i, j, v = (np.concatenate(a) for a in (i, j, v))
    p = rng.permutation(len(i))
    return i[p], j[p], v[p]


def test_coo_shuffled_with_duplicates_and_a_refresh_matches_jax():
    i, j, v = _coo_case(0)
    _init_both()
    Ms = []
    for pkg in (ptt, pt_jax):
        M = pkg.MatAIJ()
        M.setSizes((30, 30))
        M.setPreallocationCOO(i, j)
        M.setValuesCOO(v)
        Ms.append(M)
    _same_csr(*Ms)
    s0 = Ms[0].state
    for M in Ms:
        M.setValuesCOO(np.cos(v))
    assert Ms[0].state > s0
    _same_csr(*Ms)
    dp, dj = Ms[0].getDiagonal().getArray(), Ms[1].getDiagonal().getArray()
    assert np.array_equal(dp, dj) and np.array_equal(dp, Ms[0].to_scipy().diagonal())
    assert Ms[0]._coo_plan["seg"] is not None       # duplicates take the segmented sum


def test_coo_without_duplicates_is_one_gather():
    A = _rand(25, 25, 4) + sp.eye(25)
    A = A.tocoo()
    p = np.random.default_rng(1).permutation(A.nnz)
    ptt.init(device="cpu")
    M = ptt.Mat.createAIJ(25, coo=(A.row[p], A.col[p], A.data[p]))
    assert M._coo_plan["seg"] is None and M._coo_plan["perm"].dtype == torch.int32
    assert (M.to_scipy() != A.tocsr()).nnz == 0
    assert np.array_equal(M.getDiagonal().getArray(), A.diagonal())


def test_setvalues_after_coo_merges_the_device_values():
    """A reference fault (ROADMAP section 3): after setValuesCOO its host
    values are None, and a later setValues + assemble fails in
    np.concatenate. The port fetches the device values first."""
    _init_both()
    Ms = []
    for pkg in (ptt, pt_jax):
        M = pkg.MatAIJ()
        M.setSizes((3, 3))
        M.setPreallocationCOO([0, 1, 2], [0, 1, 2])
        M.setValuesCOO([1.0, 2.0, 3.0])
        M.setValue(0, 1, 5.0)
        Ms.append(M)
    with pytest.raises(ValueError, match="concatenated"):
        Ms[1].assemble()
    Ms[0].assemble()
    assert np.array_equal(Ms[0].to_scipy().toarray(),
                          [[1.0, 5.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 3.0]])


def test_factories_match_jax():
    A = _rand(12, 9, 5)
    _init_both()
    for make in (lambda pkg: pkg.Mat.createAIJ((12, 9), csr=(A.indptr, A.indices, A.data)),
                 lambda pkg: pkg.Mat.createAIJWithArrays((12, 9), (A.indptr, A.indices, A.data)),
                 lambda pkg: pkg.Mat.createAIJ((12, 9), coo=(A.tocoo().row, A.tocoo().col,
                                                            A.tocoo().data))):
        _same_csr(make(ptt), make(pt_jax))


def test_assembly_errors():
    ptt.init(device="cpu")
    M = ptt.MatAIJ()
    M.setSizes((4, 4))
    M.setValue(0, 0, 1.0, ptt.InsertMode.ADD_VALUES)
    with pytest.raises(ptt.Error, match="mix"):
        M.setValue(0, 1, 1.0, ptt.InsertMode.INSERT_VALUES)
    with pytest.raises(ptt.Error, match="setPreallocationCOO"):
        M.setValuesCOO(np.ones(3))
    M.setPreallocationCOO([0, 1], [0, 1])
    with pytest.raises(ptt.Error, match="2 entries"):
        M.setValuesCOO(np.ones(3))
    with pytest.raises(ptt.Error, match="outside"):
        M.setPreallocationCOO([0, 4], [0, 1])
    M.setValues([0], [0], [[2.0]], ptt.InsertMode.ADD_VALUES)
    M.assemble()                          # a new pattern drops the COO plan
    with pytest.raises(ptt.Error, match="setPreallocationCOO"):
        M.setValuesCOO(np.ones(2))


def test_empty_and_rectangular_matrices_match_jax():
    _init_both()
    for shape in ((5, 3), (3, 5), (4, 4)):
        Mp, Mj = ptt.MatAIJ(), pt_jax.MatAIJ()
        for M in (Mp, Mj):
            M.setSizes(shape)
            M.assemble()
        _same_csr(Mp, Mj)
        d = Mp.device_data()
        assert d["indptr"].shape == (shape[0] + 1,) and d["col"].numel() == 0
        y = Mp.op().mult(torch.ones(shape[1], dtype=torch.float64))
        yt = Mp.op().mult_t(torch.ones(shape[0], dtype=torch.float64))
        assert torch.equal(y, torch.zeros(shape[0], dtype=torch.float64))
        assert torch.equal(yt, torch.zeros(shape[1], dtype=torch.float64))
        assert np.array_equal(Mp.getDiagonal().getArray(), np.zeros(shape[0]))


# ------------------------------------------------------------------ products

@pytest.mark.parametrize("kind", ("csr", "ell"))
@pytest.mark.parametrize("name", sorted(_matrices()))
def test_mult_and_mult_transpose_match_jax(name, kind):
    A = _matrices()[name]
    _init_both("-mat_spmv_kind", kind)
    Mp, Mj = ptt.MatAIJ.from_scipy(A), pt_jax.MatAIJ.from_scipy(A)
    assert Mj.meta[0] == f"aij_{kind}" and Mp.meta[0] == "aij_csr"
    rng = np.random.default_rng(11)
    x, xt = rng.random(A.shape[1]) - 0.5, rng.random(A.shape[0]) - 0.5
    y = Mp.op().mult(torch.from_numpy(x)).numpy()
    yt = Mp.op().mult_t(torch.from_numpy(xt)).numpy()
    assert _rel(y, np.asarray(Mj.op().mult(jnp.asarray(x)))) <= 1e-12
    assert _rel(yt, np.asarray(Mj.op().mult_t(jnp.asarray(xt)))) <= 1e-12
    # and through the Vec interface
    vy = Mp.createVecLeft()
    Mp.mult(ptt.Vec.from_array(x), vy)
    assert np.array_equal(vy.getArray(), y)
    vx = Mp.createVecRight()
    Mp.multTranspose(ptt.Vec.from_array(xt), vx)
    assert np.array_equal(vx.getArray(), yt)


@pytest.mark.parametrize("name", sorted(_matrices()))
def test_f32_mult_matches_jax(name):
    A = _matrices()[name]
    pt_jax.init(args=["-mat_spmv_kind", "csr"])
    ptt.init(args=["-real_dtype", "f32"], device="cpu")
    Mp, Mj = ptt.MatAIJ.from_scipy(A), pt_jax.MatAIJ.from_scipy(A)
    assert Mp.device_data()["vals"].dtype == torch.float32
    x = np.random.default_rng(12).random(A.shape[1])
    y = Mp.op().mult(torch.from_numpy(x.astype(np.float32)))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), np.asarray(Mj.op().mult(jnp.asarray(x)))) <= 1e-5


def test_plain_spmv_functions_match_jax():
    A = _rand(33, 21, 9)
    rng = np.random.default_rng(2)
    x, xt = rng.random(21), rng.random(33)
    ip = torch.from_numpy(A.indptr.astype(np.int64))
    col = torch.from_numpy(A.indices.astype(np.int32))
    vals = torch.from_numpy(A.data)
    rows = np.repeat(np.arange(33, dtype=np.int32), np.diff(A.indptr))
    jr, jc, jv = jnp.asarray(rows), jnp.asarray(A.indices), jnp.asarray(A.data)
    assert _rel(spmv.csr_spmv(ip, col, vals, torch.from_numpy(x)),
                spmv_jax.csr_seg_spmv(jr, jc, jv, jnp.asarray(x), 33)) <= 1e-12
    assert _rel(spmv.csr_spmv_t(ip, col, vals, torch.from_numpy(xt), 21),
                spmv_jax.csr_seg_spmv_t(jr, jc, jv, jnp.asarray(xt), 21)) <= 1e-12
    # ELL of the same matrix
    K = int(np.diff(A.indptr).max())
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], np.diff(A.indptr))
    ed, ei = np.zeros((33, K)), np.zeros((33, K), dtype=np.int32)
    ed[rows, pos], ei[rows, pos] = A.data, A.indices
    assert _rel(spmv.ell_spmv(torch.from_numpy(ed), torch.from_numpy(ei), torch.from_numpy(x)),
                spmv_jax.ell_spmv(jnp.asarray(ed), jnp.asarray(ei), jnp.asarray(x))) <= 1e-12
    assert _rel(spmv.ell_spmv_t(torch.from_numpy(ed), torch.from_numpy(ei),
                                torch.from_numpy(xt), 21),
                spmv_jax.ell_spmv_t(jnp.asarray(ed), jnp.asarray(ei), jnp.asarray(xt), 21)) \
        <= 1e-12
    # COO re-assembly with duplicates
    perm = rng.permutation(50).astype(np.int32)
    seg = np.sort(rng.integers(0, 20, 50)).astype(np.int32)
    cv = rng.random(50)
    got = spmv.coo_scatter_csr(torch.from_numpy(perm), torch.from_numpy(seg),
                               torch.from_numpy(cv), 20)
    want = spmv_jax.coo_scatter_csr(jnp.asarray(perm), jnp.asarray(seg), jnp.asarray(cv), 20)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_s2_wrapper_on_the_cpu_is_its_plain_version():
    A = _rand(50, 70, 3)
    ip = torch.from_numpy(A.indptr.astype(np.int64))
    col = torch.from_numpy(A.indices.astype(np.int32))
    vals = torch.from_numpy(A.data)
    x = torch.from_numpy(np.random.default_rng(0).random(70))
    pk.reset_launches()
    assert torch.equal(pk.csr_spmv(ip, col, vals, x), pk.csr_spmv_plain(ip, col, vals, x))
    assert pk.LAUNCHES["csr_spmv"] == 0
    # vals and col as views that start at an odd element are taken as they are
    col1 = torch.cat([col[:1], col])[1:]
    vals1 = torch.cat([vals[:1], vals])[1:]
    assert vals1.storage_offset() == 1 and col1.storage_offset() == 1
    assert torch.equal(pk.csr_spmv(ip, col1, vals1, x), pk.csr_spmv_plain(ip, col, vals, x))
    bad = {
        "indptr_int32": (ip.int(), col, vals, x),
        "col_int64": (ip, col.long(), vals, x),
        "vals_f32": (ip, col, vals.float(), x),
        "vals_length": (ip, col, vals[:-1].contiguous(), x),
        "x_strided": (ip, col, vals, torch.zeros(140, dtype=torch.float64)[::2]),
        "x_2d": (ip, col, vals, x.reshape(7, 10)),
    }
    for name, args in bad.items():
        with pytest.raises((TypeError, ValueError)):
            pk.csr_spmv(*args)


# ------------------------------------------------------------------ matrix operations

def _ops_case():
    return (_rand(12, 12, 21) + sp.diags(np.linspace(1.0, 2.0, 12))).tocsr()


def _vec(pkg, arr):
    return pkg.Vec.from_array(np.asarray(arr, dtype=np.float64))


_OPS = {
    "transpose": lambda pkg, M: M.transpose(),
    "duplicate": lambda pkg, M: M.duplicate(),
    "duplicate_pattern": lambda pkg, M: M.duplicate(copy_values=False),
    "scale": lambda pkg, M: M.scale(-2.5),
    "shift": lambda pkg, M: M.shift(0.75),
    "axpy": lambda pkg, M: M.axpy(1.5, pkg.MatAIJ.from_scipy(_rand(12, 12, 22))),
    "diagonalScale": lambda pkg, M: M.diagonalScale(_vec(pkg, np.arange(1.0, 13.0)),
                                                    _vec(pkg, np.linspace(-1, 1, 12))),
    "zeroRows": lambda pkg, M: M.zeroRows([0, 5, 11], diag=3.0),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_matrix_operations_match_jax(op):
    _init_both()
    A = _ops_case()
    out = [_OPS[op](pkg, pkg.MatAIJ.from_scipy(A)) for pkg in (ptt, pt_jax)]
    a, b = out[0].to_scipy(), out[1].to_scipy()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
    assert _rel(a.data, b.data) <= 1e-14
    assert _rel(out[0].getDiagonal().getArray(), out[1].getDiagonal().getArray()) <= 1e-14


def test_zero_rows_columns_with_x_and_b_matches_jax():
    _init_both()
    A = _ops_case()
    rng = np.random.default_rng(4)
    xv, bv = rng.random(12), rng.random(12)
    res = []
    for pkg in (ptt, pt_jax):
        M = pkg.MatAIJ.from_scipy(A)
        x, b = _vec(pkg, xv), _vec(pkg, bv)
        M.zeroRowsColumns([1, 7], diag=2.0, x=x, b=b)
        res.append((M, np.asarray(b.getArray())))
    _same_csr(res[0][0], res[1][0])
    assert _rel(res[0][1], res[1][1]) <= 1e-14


@pytest.mark.parametrize("norm", ("NORM_FROBENIUS", "NORM_1", "NORM_INFINITY"))
def test_norms_and_diagonal_match_jax(norm):
    _init_both()
    A = _ops_case()
    Mp, Mj = ptt.MatAIJ.from_scipy(A), pt_jax.MatAIJ.from_scipy(A)
    assert _rel(Mp.norm(getattr(ptt.NormType, norm)), Mj.norm(getattr(pt_jax.NormType, norm))) \
        <= 1e-14
    assert np.array_equal(Mp.getDiagonal().getArray(), np.asarray(Mj.getDiagonal().getArray()))


def test_diagonal_vec_is_a_copy():
    ptt.init(device="cpu")
    M = ptt.MatAIJ.from_scipy(_ops_case())
    d = M.getDiagonal()
    d.scale(0.0)
    assert np.array_equal(M.getDiagonal().getArray(), _ops_case().diagonal())


def test_value_changes_bump_the_state_and_reach_the_pc():
    ptt.init(args=["-ksp_type", "cg", "-pc_type", "jacobi"], device="cpu")
    A = (_ops_case() + _ops_case().T).tocoo()
    M = ptt.Mat.createAIJ(12, coo=(A.row, A.col, A.data))
    ksp = ptt.KSP().create()
    ksp.setOperators(M)
    ksp.setFromOptions()
    ksp.solve(_vec(ptt, np.ones(12)))
    inv0 = ksp.getPC().device_data()["inv"].clone()
    for change in (lambda: M.setValuesCOO(2 * A.data), lambda: M.scale(0.5),
                   lambda: M.shift(1.0)):
        s = M.state
        change()
        assert M.state > s
    ksp.solve(_vec(ptt, np.ones(12)))
    inv1 = ksp.getPC().device_data()["inv"]
    assert torch.allclose(inv1, 1.0 / (1.0 / inv0 + 1.0), rtol=1e-15)


# ------------------------------------------------------------------ layout options and errors

@pytest.mark.parametrize("kind", ("auto", "csr", "ell", "dia", "hyb", "bdia", "perm"))
def test_every_accepted_layout_gives_the_same_product(kind):
    A = (_rand(64, 64, 31, 0.1) + sp.eye(64)).tocsr()
    x = np.random.default_rng(3).random(64)
    pt_jax.init(args=["-mat_spmv_kind", "csr"])
    want = np.asarray(pt_jax.MatAIJ.from_scipy(A).op().mult(jnp.asarray(x)))
    ptt.init(args=["-mat_spmv_kind", "auto"], device="cpu")
    auto = ptt.MatAIJ.from_scipy(A).op().mult(torch.from_numpy(x))
    ptt.init(args=["-mat_spmv_kind", kind], device="cpu")
    M = ptt.MatAIJ.from_scipy(A)
    y = M.op().mult(torch.from_numpy(x))
    assert M.meta[0] == "aij_csr" and torch.equal(y, auto)
    assert _rel(y.numpy(), want) <= 1e-12


@pytest.mark.parametrize("kind,slice_name", (("dndb", "BAIJ"), ("bell", "BAIJ")))
def test_later_layouts_raise_naming_their_slice(kind, slice_name):
    """The block layouts, once refused naming the BAIJ slice, are ported
   : both options give the BSR layout, whose product (B1's plain
    version here) equals scipy's."""
    A = sp.random(12, 12, density=0.4, random_state=2, format="csr") + sp.eye(12)
    x = np.random.default_rng(3).random(12)
    ptt.init(args=["-mat_spmv_kind", kind], device="cpu")
    M = ptt.MatAIJ.from_scipy(A.tocsr())
    assert M.meta[0] == "aij_bsr" and slice_name == "BAIJ"
    assert _rel(M.op().mult(torch.from_numpy(x)).numpy(), A @ x) <= 1e-13


def test_the_dnd_layout_on_a_declared_grid_matches_the_reference():
    """-mat_spmv_kind dnd (once refused, now the grid layout): the 2-D
    5-point operator on its 8 x 8 grid gives the reference's meta, planes
    and product."""
    n = 8
    A = sp.diags([4.0 * np.ones(n * n), -np.ones(n * n - 1), -np.ones(n * n - 1),
                  -np.ones(n * n - n), -np.ones(n * n - n)], [0, 1, -1, n, -n], format="csr")
    x = np.random.default_rng(5).random(n * n)
    # the reference takes the layout under auto (its explicit dnd needs the
    # grid before the first assembly, which from_scipy does)
    pt_jax.init()
    Mj = pt_jax.MatAIJ.from_scipy(A).setStencilGrid((n, n))
    ptt.init(args=["-mat_spmv_kind", "dnd"], device="cpu")
    M = ptt.MatAIJ()
    M.setSizes(n * n)
    M.setStencilGrid((n, n))
    M.setValuesCSR(A.indptr, A.indices, A.data)
    M.assemble()
    assert M.meta == Mj.meta and M.meta[0] == "aij_dnd"
    assert np.array_equal(M.device_data()["coef"].numpy(), np.asarray(Mj.device_data()["coef"]))
    y = M.op().mult(torch.from_numpy(x))
    assert _rel(y.numpy(), np.asarray(Mj.op().mult(jnp.asarray(x)))) <= 1e-13
    assert _rel(y.numpy(), A @ x) <= 1e-13


def test_block_size_unknown_kind_spgemm_and_dense_raise():
    ptt.init(device="cpu")
    M = ptt.MatAIJ()
    M.setSizes((8, 8), bs=2)
    M.assemble()          # block sizes above 1 are ported: an empty BSR
    assert M.meta[0] == "aij_bsr" and M.nnz() == 0
    assert not M.op().mult(torch.ones(8, dtype=torch.float64)).any()
    ptt.init(args=["-mat_spmv_kind", "sell"], device="cpu")
    with pytest.raises(ptt.Error, match="sell"):
        ptt.MatAIJ.from_scipy(sp.eye(4, format="csr"))
    ptt.init(device="cpu")
    # the SpGEMM methods are ported (ROADMAP item 5a): products equal scipy's
    E = sp.csr_matrix(np.arange(16.0).reshape(4, 4) % 5)
    M = ptt.MatAIJ.from_scipy(E)
    for got, want in ((M.matMult(M), E @ E), (M.transposeMatMult(M), E.T @ E),
                      (M.ptap(M), E.T @ E @ E), (M.rart(M), E @ E @ E.T),
                      (M.createSubMatrix([0, 1]), E[[0, 1]][:, [0, 1]])):
        assert got.meta[0] == "aij_csr"
        np.testing.assert_array_equal(got.to_scipy().toarray(), want.toarray())
    # convert("dense") is ported with MatDense (ROADMAP item 7)
    D = M.convert("dense")
    assert type(D).__name__ == "MatDense"
    np.testing.assert_array_equal(D.getDenseArray(), E.toarray())


# ------------------------------------------------------------------ files and interop

@pytest.mark.parametrize("name", FIXTURES)
def test_matrix_market_matches_jax(name, tmp_path):
    _init_both()
    Mp = mmio.load_matrix_market(DATA / name)
    _same_csr(Mp, mmio_jax.load_matrix_market(DATA / name))
    mmio.save_matrix_market(tmp_path / name, Mp)
    assert (sp.csr_matrix(scipy.io.mmread(tmp_path / name)) != Mp.to_scipy()).nnz == 0


@pytest.mark.parametrize("kind", ("csr", "ell"))
def test_interop_carries_the_jax_state_across(kind):
    A = _rand(30, 25, 13)
    A.data[::7] = 0.0                   # stored zeros survive the ELL layout
    _init_both("-mat_spmv_kind", kind)
    Mj = pt_jax.MatAIJ.from_scipy(A)
    assert Mj.meta[0] == f"aij_{kind}"
    data = {k: np.asarray(v) for k, v in Mj.device_data().items()}
    _same_csr(interop.mat_from_meta_data(Mj.meta, data), Mj)
    ip, ind, vals = Mj.getValuesCSR()
    _same_csr(interop.mat_from_csr(ip, ind, vals, Mj.getSize()), Mj)
