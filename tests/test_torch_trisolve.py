"""petsc_tpu_torch.ops.trisolve (kernel T1's plain version) and
petsc_tpu_torch.mat.factor against the JAX package.

The sweeps run on identical plans: the reference's plan carried into the
port by ``interop.trisolve_plan_from_jax``, and the port's own plan from
the same factors. The factors (ILU(0), ILU(k), SuperLU) come from the
same host algorithms in both packages.

Tolerances: the factors equal the reference's bit for bit (the same C++
and numpy code); the sweeps agree to 1e-12 relative in float64 (the
reference sums each row's padded ELL slots in XLA's order, the port the
row's entries in column order) and to 1e-6 in float32 vectors (each level's
result is rounded to float32 before the next level reads it); against
scipy's triangular solve 1e-12; the port's own plan equals the plan carried
from the reference bit for bit (same levels, same order of sums)."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp
from petsc_tpu.mat import factor as factor_jax
from petsc_tpu.ops import trisolve as ts_jax
import petsc_tpu_torch as ptt
from petsc_tpu_torch import interop
from petsc_tpu_torch.mat import factor
from petsc_tpu_torch.ops import trisolve
from petsc_tpu_torch.ops.stencil_build import stencil7_coo
from petsc_tpu_torch.sys.error import Error

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.init(device="cpu")


def _matrix(kind):
    """A diagonally dominant non-symmetric CSR, columns sorted."""
    if kind == "stencil7":
        i, j, v = stencil7_coo(4, 9, 11)
        n = 4 * 9 * 11
        A = sp.csr_matrix((v, (i, j)), shape=(n, n))
    else:
        n = 300
        R = sp.random(n, n, density=0.02, format="csr", random_state=3)
        A = (R + sp.diags(np.full(n, 4.0) + np.arange(n) % 5)).tocsr()
    A.sort_indices()
    return A


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _triples_equal(p, r):
    for a, b in zip(p, r):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ("stencil7", "random"))
@pytest.mark.parametrize("k", (0, 1, 2))
def test_iluk_factors_equal_the_reference(kind, k):
    A = _matrix(kind)
    L, U, dinv = factor.iluk(A.indptr, A.indices, A.data, k)
    Lr, Ur, dr = factor_jax.iluk(A.indptr, A.indices, A.data, k)
    _triples_equal(L, Lr)
    _triples_equal(U, Ur)
    assert np.array_equal(dinv, dr)
    if k == 0:
        L0, U0, d0 = factor.ilu0(A.indptr, A.indices, A.data)
        _triples_equal(L0, L)
        assert np.array_equal(d0, dinv)


def test_splu_and_spilu_factors_equal_the_reference():
    A = _matrix("random")
    for mine, ref in ((factor.splu_factors(A), factor_jax.splu_factors(A)),
                      (factor.spilu_factors(A, 1e-3, 5.0), factor_jax.spilu_factors(A, 1e-3, 5.0))):
        _triples_equal(mine[0], ref[0])
        _triples_equal(mine[1], ref[1])
        for a, b in zip(mine[2:], ref[2:]):
            assert np.array_equal(a, b)


def test_a_zero_pivot_raises():
    A = sp.csr_matrix(np.array([[1.0, 2.0], [3.0, 6.0]]))
    with pytest.raises(Error, match="zero pivot"):
        factor.ilu0(A.indptr, A.indices, A.data)


def _jax_plan(A, transpose=True):
    L, U, dinv = factor_jax.ilu0(A.indptr, A.indices, A.data)
    tail, data = ts_jax.make_trisolve_plan(L, U, dinv)
    if transpose:
        data.update(ts_jax.make_transpose_tables(L, U, dinv))
    return (L, U, dinv), tail, data


@pytest.mark.parametrize("kind", ("stencil7", "random"))
def test_the_sweeps_match_the_reference_on_its_own_plan(kind):
    A = _matrix(kind)
    (L, U, dinv), tail, data = _jax_plan(A)
    ptail, pdata = interop.trisolve_plan_from_jax(
        tail, {k: np.asarray(v) for k, v in data.items()})
    assert ptail == tuple(int(v) for v in tail)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    bt = torch.tensor(b)
    m, nl, nu = tail
    cases = [
        (trisolve.trisolve_apply(pdata, bt), ts_jax.trisolve_apply(data, jnp.asarray(b), m, nl, nu)),
        (trisolve.trisolve_transpose_apply(pdata, bt),
         ts_jax.trisolve_transpose_apply(data, jnp.asarray(b), m, nl, nu)),
        (trisolve.unit_lower_solve(pdata["L"], bt),
         ts_jax.unit_lower_solve(data["Ld"], data["Lx"], data["tabL"], jnp.asarray(b), m, nl)),
        (trisolve.unit_upper_solve(trisolve.make_sweep(*U, lower=False), bt),
         ts_jax.unit_upper_solve(data["Ud"], data["Ux"], data["tabU"], jnp.asarray(b), m, nu)),
    ]
    for got, want in cases:
        assert _rel(got.numpy(), want) <= 1e-12
    # the port's own plan from the same factors: the same levels in the same
    # order, so the same bits as the plan carried across
    _, own = trisolve.make_trisolve_plan(L, U, dinv)
    own.update(trisolve.make_transpose_tables(L, U, dinv))
    for key in ("L", "U", "Ut", "Lt"):
        assert own[key].levels == pdata[key].levels
        assert torch.equal(own[key].rows, pdata[key].rows)
    assert torch.equal(trisolve.trisolve_apply(own, bt), cases[0][0])
    assert torch.equal(trisolve.trisolve_transpose_apply(own, bt), cases[1][0])


def test_float32_vectors_on_float64_factors_match_the_reference():
    A = _matrix("stencil7")
    _, tail, data = _jax_plan(A, transpose=False)
    _, pdata = interop.trisolve_plan_from_jax(tail, {k: np.asarray(v) for k, v in data.items()})
    b = np.random.default_rng(6).standard_normal(A.shape[0]).astype(np.float32)
    got = trisolve.trisolve_apply(pdata, torch.tensor(b))
    want = ts_jax.trisolve_apply(data, jnp.asarray(b), *tail)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("lower", (True, False))
def test_a_sweep_solves_its_triangle(lower):
    A = _matrix("random")
    T = sp.tril(A, k=-1) if lower else sp.triu(A, k=1)
    T = T.tocsr()
    T.sort_indices()
    s = np.linspace(0.5, 1.5, A.shape[0])
    sw = trisolve.make_sweep(T.indptr, T.indices, T.data, lower=lower, scale=s)
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    # a sweep computes x = s (b - T x), that is (diag(1/s) + T) x = b
    M = (sp.diags(1.0 / s) + T).tocsr()
    want = spla.spsolve_triangular(M, b, lower=lower)
    got = trisolve.trisolve_sweep(sw, torch.tensor(b))
    assert _rel(got.numpy(), want) <= 1e-12
    lev, nlev = trisolve.levels_from_csr(T.indptr, T.indices, lower)
    assert sw.nlev == nlev and sw.levels[-1] == A.shape[0]
    assert np.array_equal(np.sort(sw.rows.numpy()), np.arange(A.shape[0]))
    assert sw.width == int(np.bincount(lev).max())


def test_the_wrapper_takes_the_plain_version_on_the_cpu_and_checks_its_input():
    A = _matrix("stencil7")
    L, U, dinv = factor.ilu0(A.indptr, A.indices, A.data)
    _, data = trisolve.make_trisolve_plan(L, U, dinv)
    b = torch.tensor(np.random.default_rng(8).standard_normal(A.shape[0]))
    trisolve.reset_launches()
    assert torch.equal(trisolve.trisolve_sweep(data["L"], b),
                       trisolve.trisolve_sweep_plain(data["L"], b))
    assert trisolve.LAUNCHES["trisolve"] == 0
    with pytest.raises(ValueError, match="entries"):
        trisolve.trisolve_sweep(data["L"], b[1:])
    with pytest.raises(TypeError, match="float64 or float32"):
        trisolve.trisolve_sweep(data["L"], b.to(torch.int64))


def test_more_than_int32_entries_raise(monkeypatch):
    monkeypatch.setattr(trisolve, "_INT32_MAX", 10)
    A = _matrix("random")
    T = sp.tril(A, k=-1).tocsr()
    with pytest.raises(Error, match="2\\^31"):
        trisolve.make_sweep(T.indptr, T.indices, T.data, lower=True)


def test_sor_sweeps_keep_the_real_dtype():
    ptt.init(args=["-real_dtype", "f32", "-pc_type", "sor"], device="cpu")
    A = _matrix("stencil7")
    M = ptt.MatAIJ.from_scipy(A)
    pc = ptt.PC().create()
    pc.setOperators(M)
    pc.setFromOptions()
    data = pc.device_data()
    assert data["L"].vals.dtype == torch.float32 and data["dinv"].dtype == torch.float32
