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

import chip_smoke
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


def test_a_sweep_keeps_its_columns_as_level_positions():
    """pcols is each entry's column as a position in level order: the
    position of that row in rows."""
    A = _matrix("random")
    L, U, dinv = factor.ilu0(A.indptr, A.indices, A.data)
    for sw in trisolve.make_trisolve_plan(L, U, dinv)[1].values():
        rows, cols, pcols = (t.numpy() for t in (sw.rows, sw.cols, sw.pcols))
        assert sw.pcols.dtype == torch.int32 and np.array_equal(rows[pcols], cols)
        lev = np.repeat(np.arange(sw.nlev), np.diff(sw.levels))
        ent = np.repeat(np.arange(sw.m), np.diff(sw.rp.numpy()))
        assert (lev[pcols] < lev[ent]).all()          # every column from an earlier level


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


# ---------------------------------------------------------------------
# T1's plan (which variant a sweep takes) and its level loop in numpy
# ---------------------------------------------------------------------

def _diag(m):
    return trisolve.make_sweep(np.zeros(m + 1, dtype=np.int64), np.zeros(0, dtype=np.int64),
                               np.zeros(0), lower=True, scale=np.linspace(0.5, 2.0, m))


def _lu_sweep():
    """U of SuperLU's factors of a small stencil7: many narrow levels, rows
    longer than the depth."""
    i, j, v = stencil7_coo(3, 8, 9)
    A = sp.csr_matrix((v, (i, j)), shape=(216, 216))
    A.sort_indices()
    L, U, dinv = factor.splu_factors(A)[:3]
    return trisolve.make_sweep(*U, lower=False, scale=dinv)


def _cap():
    return trisolve._CLUSTER_BLOCKS * trisolve._CLUSTER_THREADS


@pytest.mark.parametrize("case,variant,blocks,threads", (
    ("cluster capacity", "cluster", 16, 512),
    ("one row over", "grid", 33, 256),
    ("one level, 300,001 rows", "grid", 1172, 256),
    ("one level, 100 rows", "cluster", 4, 32),
    ("LU", "cluster", None, None),
    ("ILU(2)", "cluster", None, None)))
def test_the_plan_takes_the_cluster_up_to_its_capacity(case, variant, blocks, threads):
    """The cluster variant wherever the widest level fits 16 blocks of 512
    threads at one row per thread (spread over as many blocks as that
    allows, each with the fewest warps that hold its share), the grid
    variant one row over; rows longer than the depth load the rest after
    the barrier (the plan's longest)."""
    if case == "cluster capacity":
        sw = chip_smoke.wide_sweep(_cap(), "cpu")
    elif case == "one row over":
        sw = chip_smoke.wide_sweep(_cap() + 1, "cpu")
    elif case.startswith("one level"):
        sw = _diag(300_001 if "300,001" in case else 100)
    elif case == "LU":
        sw = _lu_sweep()
    else:
        A = _matrix("random")
        L, U, dinv = factor.iluk(A.indptr, A.indices, A.data, 2)
        sw = trisolve.make_sweep(*L, lower=True)
    plan = trisolve.sweep_plan(sw)
    assert plan.variant == variant
    assert plan.longest == max(sw.widths)
    if blocks is not None:
        assert (plan.blocks, plan.threads) == (blocks, threads)
    if variant == "cluster":
        share = -(-sw.width // trisolve._CLUSTER_BLOCKS)
        assert plan.threads == max(32, -(-share // 32) * 32)
        assert plan.blocks * plan.threads >= sw.width > (plan.blocks - 1) * plan.threads
        assert plan.blocks <= trisolve._CLUSTER_BLOCKS
    assert trisolve.sweep_plan(sw) is plan      # made once per sweep shape
    if case == "LU":
        assert sw.nlev > 100 and sw.width < 32 and plan.longest > trisolve._DEPTH
    if case == "ILU(2)":
        assert plan.longest > trisolve._DEPTH
    # a cluster of at most 0 blocks leaves the grid variant
    assert trisolve.sweep_plan(sw, max_blocks=0).variant == "grid"


def test_a_cluster_the_card_cannot_place_raises(monkeypatch):
    """Where the occupancy calculator holds no cluster of the plan's shape,
    the launch raises before the kernel is called: no other variant and
    no plain version takes its place."""
    sw = _diag(100)
    plan = trisolve.sweep_plan(sw)
    assert plan.variant == "cluster"
    called = []
    monkeypatch.setattr(trisolve, "_card_config", lambda *a: {"clusters_that_fit": 0})
    monkeypatch.setattr(trisolve.cuda_build, "launch", lambda *a, **k: called.append(a))
    monkeypatch.setattr(trisolve, "_PLACED", set())
    b = torch.ones(sw.m, dtype=torch.float64)
    with pytest.raises(Error, match="cannot place a cluster of 4 blocks of 32 threads"):
        trisolve._launch({"trisolve": 0}, sw, b, torch.empty_like(b), plan)
    assert called == []


@pytest.mark.parametrize("key", ("L", "U"))
def test_the_entries_removed_sweep_keeps_the_levels(key):
    """chip_smoke's sweep with every entry removed (the barrier and the row
    loads alone) keeps the source sweep's levels, rows and widest level;
    its rows have no entries, and its plain version is b times the scale,
    exactly."""
    A = _matrix("stencil7")
    L, U, dinv = factor.ilu0(A.indptr, A.indices, A.data)
    _, data = trisolve.make_trisolve_plan(L, U, dinv)
    sw = data[key]
    e = chip_smoke.empty_sweep(trisolve, sw)
    assert e.levels == sw.levels and e.width == sw.width and e.nlev == sw.nlev
    assert torch.equal(e.rows, sw.rows) and e.nnz == 0 and set(e.widths) == {0}
    assert max(sw.widths) == 3
    b = torch.tensor(np.random.default_rng(9).standard_normal(sw.m))
    want = b.clone()
    if key == "U":
        want = b * torch.tensor(dinv)
    assert torch.equal(trisolve.trisolve_sweep(e, b), want)


def _kernel_loop(sw, b, nthreads):
    """csrc/trisolve.cu's trisolve_kernel in numpy, every thread at once:
    thread t takes position lev_ptr[l] + t of each level l, and + nthreads,
    ... for a wider level; between the barrier's halves after level l each
    thread loads b, the scale and the first depth entries of its first
    row of level l + 2, and the row and row pointers of level l + 3; after
    the barrier xl (x in level order) at the loaded columns' positions,
    then the rest of the row; each result is stored in xl at its position
    and in x at its row. Sums in the promoted type, each product and sum
    rounded alone. xl starts as NaN and every read of it is checked to
    come from an earlier level."""
    depth = trisolve._DEPTH
    rows, rp, cols = (t.numpy().astype(np.int64) for t in (sw.rows, sw.rp, sw.pcols))
    vals, bn = sw.vals.numpy(), b.numpy()
    scale = None if sw.scale is None else sw.scale.numpy()
    acc = np.float32 if (bn.dtype == np.float32 and vals.dtype == np.float32) else np.float64
    tid = np.arange(nthreads)
    xl = np.full(sw.m, np.nan, dtype=bn.dtype)      # x in level order
    x = np.full(sw.m, np.nan, dtype=bn.dtype)
    written = np.full(sw.m, sw.nlev)          # the level that wrote each xl

    def at(k):
        return sw.levels[min(k, sw.nlev)]

    def meta(p0, p1):
        p = p0 + tid
        ok = p < p1
        q = np.where(ok, p, 0)
        return {"ok": ok, "p": q, "row": np.where(ok, rows[q], 0),
                "e0": np.where(ok, rp[q], 0), "e1": np.where(ok, rp[np.minimum(q + 1, sw.m)], 0)}

    def ops(m):
        o = dict(m)
        o["b"] = np.where(m["ok"], bn[m["row"]], 0)
        o["sc"] = np.where(m["ok"], scale[m["p"]], 1) if scale is not None else None
        has = [m["ok"] & (m["e0"] + k < m["e1"]) for k in range(depth)]
        ent = [np.where(h, m["e0"] + k, 0) for k, h in enumerate(has)]
        o["col"] = [np.where(h, cols[e] if len(cols) else 0, 0) for h, e in zip(has, ent)]
        o["val"] = [np.where(h, vals[e] if len(vals) else 0, 0).astype(vals.dtype)
                    for h, e in zip(has, ent)]
        o["has"] = has
        return o

    def read_x(c, lv, has=True):
        assert (written[c] < lv)[has].all()
        return np.where(has, xl[c], 0).astype(acc)

    lp = [at(k) for k in range(5)]
    cur = ops(meta(lp[0], lp[1]))
    nxt = ops(meta(lp[1], lp[2]))
    ahead = meta(lp[2], lp[3])
    for lv in range(sw.nlev):
        xv = [read_x(c, lv, h) for h, c in zip(cur["has"], cur["col"])]
        s = np.zeros(nthreads, dtype=acc)
        for h, v, xk in zip(cur["has"], cur["val"], xv):
            s = np.where(h, s + v.astype(acc) * xk, s)
        for t in np.nonzero(cur["ok"] & (cur["e1"] - cur["e0"] > depth))[0]:
            for e in range(cur["e0"][t] + depth, cur["e1"][t]):
                s[t] = s[t] + acc(vals[e]) * read_x(np.array([cols[e]]), lv)[0]
        v = cur["b"].astype(acc) - s
        if scale is not None:
            v = v * cur["sc"].astype(acc)
        ok = cur["ok"]
        xl[cur["p"][ok]] = v[ok].astype(bn.dtype)
        written[cur["p"][ok]] = lv
        x[cur["row"][ok]] = v[ok].astype(bn.dtype)
        for p in range(lp[0] + nthreads, lp[1]):       # further rows, nothing ahead
            r = rows[p]
            s1 = acc(0)
            for e in range(rp[p], rp[p + 1]):
                s1 = s1 + acc(vals[e]) * read_x(np.array([cols[e]]), lv)[0]
            v1 = acc(bn[r]) - s1
            if scale is not None:
                v1 = v1 * acc(scale[p])
            xl[p] = x[r] = v1.astype(bn.dtype)
            written[p] = lv
        if lv + 1 == sw.nlev:
            break
        # between the barrier's halves: level lv + 2's operands, lv + 3's rows
        far = ops(ahead)
        ahead = meta(lp[3], lp[4])
        cur, nxt = nxt, far
        lp = lp[1:] + [at(lv + 5)]
    return torch.from_numpy(x)


@pytest.mark.parametrize("case", ("stencil7 ILU(0)", "ILU(2) random", "LU", "float32 factor"))
@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_the_kernels_level_loop_equals_plain(case, dtype):
    """The kernel's schedule (loads a level ahead, the rest of a long row
    after the barrier, further rows of a wide level) rebuilt in numpy
    equals the plain version bit for bit with a thread per row of the
    widest level (the cluster variant) and with fewer threads than rows
    (the grid variant's wide levels), and reads x only from earlier
    levels."""
    if case == "LU":
        sweeps = {"U": _lu_sweep()}
    else:
        A = _matrix("random" if "random" in case else "stencil7")
        L, U, dinv = factor.iluk(A.indptr, A.indices, A.data, 2 if "ILU(2)" in case else 0)
        if case == "float32 factor":
            sweeps = {"L": trisolve.make_sweep(*L, lower=True, dtype=torch.float32)}
        else:
            _, sweeps = trisolve.make_trisolve_plan(L, U, dinv)
            sweeps.update(trisolve.make_transpose_tables(L, U, dinv))
    b = torch.tensor(np.random.default_rng(10).uniform(0.5, 1.5, 400)).to(dtype)
    for name, sw in sweeps.items():
        bb = b[:sw.m].contiguous() if sw.m <= 400 else torch.rand(sw.m, dtype=dtype)
        p = trisolve.trisolve_sweep_plain(sw, bb)
        plan = trisolve.sweep_plan(sw)
        for nthreads in (plan.blocks * plan.threads, 7):
            k = _kernel_loop(sw, bb, nthreads)
            assert torch.equal(k, p), (name, nthreads)
