"""PCGAMG's aggregation tail in petsc_tpu_torch against petsc_tpu: the
native strength, MIS, square fix-up and HEM kernels (with the pure-Python
MIS loop of the reference as the oracle), the tentative and smoothed
prolongators, the assembled smoothed prolongator against the reference's
factored one, each level of the hierarchy, CG+GAMG solves of the
reference's contract tests and of the box27 operator that chip_smoke.py
drives at 128^3, the float32 cycle, and the refusals of what later slices
bring.

Tolerances: the native kernels' outputs are equal (the same C++ on both
sides); the prolongators to 1e-14 relative (the same numpy and scipy
calls, whose sums may round apart); one application of P or P^T to 1e-12
(the port applies the assembled P, the reference the factored form);
the Chebyshev bounds to 1e-12; solver histories to 1e-6 relative with
equal iteration counts and reasons (the float32 cycle to 1e-4)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import petsc_tpu as pt_jax
import petsc_tpu_torch as ptt
from petsc_tpu import native as native_jax
from petsc_tpu.ops import operator as operator_jax
from petsc_tpu.pc import gamg as gamg_jax
from petsc_tpu_torch import native
from petsc_tpu_torch.ops import operator, stencil_build
from petsc_tpu_torch.pc import gamg

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _same_csr(C, R):
    assert C.shape == R.shape
    assert np.array_equal(C.indptr, R.indptr) and np.array_equal(C.indices, R.indices)
    assert np.array_equal(C.data, R.data)


def _mis_oracle(G, perm):
    """The reference's pure-Python greedy MIS loop (petsc_tpu/pc/gamg.py:92-106)."""
    indptr, indices = G.indptr, G.indices
    agg = np.full(G.shape[0], -2, dtype=np.int64)
    roots = []
    for v in perm:
        if agg[v] != -2:
            continue
        nbrs = indices[indptr[v]:indptr[v + 1]]
        if len(nbrs) < 2:
            agg[v] = -1
            continue
        agg[v] = len(roots)
        und = nbrs[agg[nbrs] == -2]
        agg[und] = agg[v]
        roots.append(v)
    agg[agg == -2] = -1
    return agg, len(roots), np.asarray(roots, dtype=np.int64)


def _sym_random(index_dtype=np.int32):
    """tests/test_gamg_structured.py::test_native_strength_and_mis2_match_python's graph."""
    A = sp.random(400, 400, density=0.02, format="csr", random_state=9)
    A = (A + A.T + sp.identity(400)).tocsr()
    A.indptr, A.indices = A.indptr.astype(index_dtype), A.indices.astype(index_dtype)
    return A


def poisson2d(n):
    """tests/test_mg_gamg.py's 2-D 5-point Laplacian."""
    main = 4.0 * np.ones(n * n)
    side = -np.ones(n * n - 1)
    side[np.arange(1, n * n) % n == 0] = 0.0
    ud = -np.ones(n * n - n)
    return sp.diags([main, side, side, ud, ud], [0, 1, -1, n, -n], format="csr")


def poisson3d(n):
    """tests/test_mg_gamg.py's 3-D 7-point Laplacian."""
    I = sp.eye(n)
    T = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1])
    return (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
            + sp.kron(sp.kron(I, I), T)).tocsr()


def anisotropic2d(n=32, eps=1e-3):
    """tests/test_mg_gamg.py::test_gamg_anisotropic_threshold's operator."""
    I = sp.eye(n)
    Tx = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1])
    return (sp.kron(I, Tx) + eps * sp.kron(Tx, I)).tocsr()


def box27(n):
    i, j, v = chip_smoke.box27_coo(n)
    return sp.csr_matrix((v, (i, j)), shape=(n ** 3, n ** 3))


# ------------------------------------------------------------------ native kernels

@pytest.mark.parametrize("index_dtype", (np.int32, np.int64))
@pytest.mark.parametrize("threshold", (-1.0, 0.05))
def test_strength_sym_matches_the_reference(threshold, index_dtype):
    A = _sym_random(index_dtype)
    G = native.strength_sym(A, threshold)
    _same_csr(G, native_jax.strength_sym(A, threshold))
    # the definition (agg.c:752): |A| + |A|^T, weak entries dropped, diagonal kept
    Gr = abs(A).tocsr()
    Gr = (Gr + Gr.T).tocsr()
    if threshold >= 0:
        d = np.sqrt(np.abs(Gr.diagonal()))
        rows = np.repeat(np.arange(400), np.diff(Gr.indptr))
        keep = (np.abs(Gr.data) > threshold * d[rows] * d[Gr.indices]) | (Gr.indices == rows)
        Gr = sp.csr_matrix((Gr.data[keep], (rows[keep], Gr.indices[keep])), shape=Gr.shape)
    assert G.nnz == Gr.nnz
    assert np.allclose(G.toarray(), Gr.toarray())
    assert np.array_equal(gamg.strength_graph(A, threshold=threshold).toarray(), G.toarray())


def test_mis_kernels_match_the_reference_and_the_python_oracle():
    A = _sym_random()
    G = native.strength_sym(A, -1.0)
    perm = np.random.default_rng(11).permutation(400)
    # MIS on G and on its implicit square
    for got, want in ((native.mis_aggregate(G.indptr, G.indices, perm), _mis_oracle(G, perm)),
                      (native.mis2_aggregate(G.indptr, G.indices, perm),
                       _mis_oracle(gamg.square_graph(G), perm))):
        assert got[1] == want[1]
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[2], want[2])
    agg, nagg, roots = native.mis2_aggregate(G.indptr, G.indices, perm)
    agg_j, nagg_j, roots_j = native_jax.mis2_aggregate(G.indptr.astype(np.int64),
                                                       G.indices.astype(np.int64), perm)
    assert nagg == nagg_j and np.array_equal(agg, agg_j) and np.array_equal(roots, roots_j)
    fixed = native.fix_aggregates(G.indptr, G.indices, roots, agg.copy())
    want = native_jax.fix_aggregates(G.indptr.astype(np.int64), G.indices.astype(np.int64),
                                     roots, agg.copy())
    assert np.array_equal(fixed, want)
    # the module's functions, in the reference's default visit order
    for name in ("mis_aggregate", "mis_aggregate_squared"):
        got, want = getattr(gamg, name)(G), getattr(gamg_jax, name)(G)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    got = gamg.fix_aggregates_with_square(G, agg.copy(), roots)
    assert np.array_equal(got, gamg_jax.fix_aggregates_with_square(G, agg.copy(), roots))


@pytest.mark.parametrize("threshold", (0.0, 0.3))
def test_hem_match_matches_the_reference(threshold):
    """Exact serial HEM on the scaled graph of the 2-D Laplacian (three rounds)."""
    G = gamg._hem_graph(poisson2d(32), threshold)
    assert np.allclose(G.diagonal(), 1.0)
    agg, nagg = native.hem_match(G.indptr, G.indices, G.data, 3, threshold)
    agg_j, nagg_j = native_jax.hem_match(G.indptr.astype(np.int64),
                                         G.indices.astype(np.int64), G.data, 3, threshold)
    assert nagg == nagg_j and np.array_equal(agg, agg_j)
    assert (agg >= 0).all() and agg.max() == nagg - 1


def test_prolongators_match_the_reference():
    A = box27(12)
    G = gamg.strength_graph(A)
    agg, nagg, roots = gamg.mis_aggregate_squared(G)
    agg = gamg.fix_aggregates_with_square(G, agg, roots)
    Bn = np.ones((A.shape[0], 1))
    P0, Bc = gamg.tentative_prolongator(agg, nagg, Bn)
    P0_j, Bc_j = gamg_jax.tentative_prolongator(agg, nagg, Bn)
    assert np.array_equal(P0.indptr, P0_j.indptr) and np.array_equal(P0.indices, P0_j.indices)
    assert _rel(P0.data, P0_j.data) <= 1e-14 and _rel(Bc, Bc_j) <= 1e-14
    dinv = 1.0 / A.diagonal()
    P = gamg._smooth_prol(A, P0, dinv, 1.4 / 1.49)
    P_j = gamg_jax._smooth_prol(A, P0_j, dinv, 1.4 / 1.49)
    assert np.array_equal(P.indptr, P_j.indptr) and np.array_equal(P.indices, P_j.indices)
    assert _rel(P.data, P_j.data) <= 1e-14
    _same_csr(gamg._galerkin(A, P), gamg_jax._galerkin(A, P_j))


# ------------------------------------------------------------------ the hierarchy

_SETUPS = {}


def _gamg_ksp(pkg, A_sp, args=()):
    """CG+GAMG on A_sp with rtol 1e-8 and the options `args`, set up (each
    (package, operator, options) built once per test process)."""
    key = (pkg.__name__, id(A_sp), tuple(args))
    if key not in _SETUPS:
        full = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8", *args]
        if pkg is ptt:
            ptt.init(args=full, device="cpu")
        else:
            pt_jax.init(args=full)
        A = pkg.MatAIJ.from_scipy(A_sp)
        ksp = pkg.KSP().create()
        ksp.setOperators(A)
        ksp.setFromOptions()
        ksp.setUp()
        _SETUPS[key] = (ksp, A)
    return _SETUPS[key]


BOX = {16: box27(16), 32: box27(32)}
# rows per level of the reference (gamg_contract.py, PERF.md section 4)
BOX_ROWS = {16: [4096, 110, 13], 32: [32768, 794, 70, 3]}


@pytest.mark.parametrize("n", (16, 32))
def test_each_level_matches_the_reference(n):
    levels = [_gamg_ksp(pkg, BOX[n])[0].getPC()._impl.levels for pkg in (pt_jax, ptt)]
    want, got = ([[lev.A.getSize()[0] for lev in ls], [lev.A.nnz() for lev in ls],
                  [lev.P.to_scipy().nnz for lev in ls[:-1]]] for ls in levels)
    assert got == want and got[0] == BOX_ROWS[n]
    for lj, lp in zip(*levels):
        if lj.agg is None:
            assert lp.agg is None
            continue
        assert np.array_equal(lp.agg, lj.agg) and lp.agg_bs == lj.agg_bs == 1
        assert abs(lp.emax - lj.emax) <= 1e-12 * lj.emax
        assert abs(lp.emin - lj.emin) <= 1e-12 * lj.emin
        assert type(lp.P).__name__ == type(lj.P).__name__ == "MatSmoothedProl"


def test_the_assembled_prolongator_applies_as_the_reference_factored_one():
    """P x_c and P^T r on every level of the 16^3 hierarchy: the port's S2
    on the assembled P and on R = P^T against the reference's
    _bind_prol_sa mult and mult_t."""
    kj, _ = _gamg_ksp(pt_jax, BOX[16])
    kp, _ = _gamg_ksp(ptt, BOX[16])
    rng = np.random.default_rng(4)
    levels = kp.getPC().device_data()["levels"]
    for l, (lj, lp) in enumerate(zip(kj.getPC()._impl.levels[:-1], kp.getPC()._impl.levels)):
        assert lj.P.meta[0] == "prol_sa" and lp.P.meta[0] == "aij_csr"
        Pj = operator_jax.bind(lj.P.meta, lj.P.device_data())
        nf, nc = lp.P.getSize()
        xc, r = rng.random(nc) - 0.5, rng.random(nf) - 0.5
        Pp = operator.bind(lp.P.meta, lp.P.device_data())
        Rp = operator.bind(("aij_csr", nc, nf), levels[l]["R"])
        assert _rel(Pp.mult(torch.as_tensor(xc)).numpy(), np.asarray(Pj.mult(xc))[:nf]) <= 1e-12
        assert _rel(Rp.mult(torch.as_tensor(r)).numpy(), np.asarray(Pj.mult_t(r))) <= 1e-12


# ------------------------------------------------------------------ solves

def _solve(pkg, A_sp, args, rhs):
    ksp, A = _gamg_ksp(pkg, A_sp, args)
    n = A_sp.shape[0]
    u = np.random.default_rng(3).random(n)
    b = A.createVecLeft()
    if rhs == "ones":
        b.set(1.0)
    else:
        b.setArray(A_sp @ u)
    x = A.createVecRight()
    ksp.solve(b, x)
    xs = np.asarray(x.getArray())[:n]
    err = (np.linalg.norm(A_sp @ xs - 1.0) / np.sqrt(n) if rhs == "ones"
           else np.linalg.norm(xs - u) / np.linalg.norm(u))
    return ksp, err


ANISO = anisotropic2d()
SOLVES = {
    # name: (operator, options, right-hand side, the reference test's bounds: its, error)
    "test_gamg_poisson2d": (poisson2d(48), (), "Au", 12, 1e-6),
    "test_gamg_poisson3d": (poisson3d(20), (), "Au", 12, 1e-6),
    "test_gamg_anisotropic_threshold": (ANISO, ("-ksp_max_it", "200"), "Au", 200, 1e-6),
    "test_ex45_analog_cg_gamg": (poisson3d(16), ("-ksp_max_it", "50"), "ones", 12, 1e-6),
    "test_hem_coarsening_gamg": (poisson2d(32), ("-pc_gamg_mat_coarsen_type", "hem"), "ones",
                                 25, 1e-6),
    "box27_16": (BOX[16], (), "ones", 8, 1e-7),
    "box27_32": (BOX[32], (), "ones", 8, 1e-7),
    "nsmooths_0": (BOX[16], ("-pc_gamg_agg_nsmooths", "0"), "ones", 20, 1e-6),
    "nsmooths_2": (BOX[16], ("-pc_gamg_agg_nsmooths", "2"), "ones", 12, 1e-6),
    "threshold_0.05": (ANISO, ("-pc_gamg_threshold", "0.05"), "Au", 100, 1e-6),
    "aggressive_0": (BOX[16], ("-pc_gamg_aggressive_coarsening", "0"), "ones", 12, 1e-6),
}


@pytest.mark.parametrize("name", SOLVES)
def test_cg_gamg_matches_the_reference(name):
    A_sp, args, rhs, max_its, max_err = SOLVES[name]
    kj, _ = _solve(pt_jax, A_sp, args, rhs)
    kp, err = _solve(ptt, A_sp, args, rhs)
    assert kp.getIterationNumber() == kj.getIterationNumber() <= max_its
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"
    np.testing.assert_allclose(kp.getConvergenceHistory(), kj.getConvergenceHistory(),
                               rtol=1e-6, atol=0)
    assert err < max_err
    if name.startswith("box27"):
        assert kp.getIterationNumber() == 8          # gamg_contract.py at 16^3 and 32^3
    if name == "nsmooths_2":
        assert all(type(lev.P).__name__ == "MatAIJ"
                   for lev in kp.getPC()._impl.levels[:-1])


def test_the_f32_cycle_matches_the_reference():
    args = ("-pc_mg_dtype", "single")
    kj, _ = _solve(pt_jax, BOX[16], args, "ones")
    kp, _ = _solve(ptt, BOX[16], args, "ones")
    assert kp.getPC().device_data()["levels"][0]["A"]["vals"].dtype == torch.float32
    assert kp.getIterationNumber() == kj.getIterationNumber() == 8
    assert kp.getConvergedReason().name == kj.getConvergedReason().name == "CONVERGED_RTOL"
    np.testing.assert_allclose(kp.getConvergenceHistory(), kj.getConvergenceHistory(),
                               rtol=1e-4, atol=0)


def test_the_setup_events_are_logged():
    ptt.init(args=["-ksp_type", "cg", "-pc_type", "gamg"], device="cpu")
    ptt.log().reset()
    A = ptt.MatAIJ.from_scipy(box27(8))
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.setUp()
    for ev in ("download", "native", "graph", "coarsen", "prol0", "emax", "smooth_prol",
               "SpGEMM"):
        assert ptt.log().get_event(f"PCGAMGSetUp_{ev}") is not None, ev
    assert ptt.log().get_event("PCMGSetUp_LU") is not None


# ------------------------------------------------------------------ refusals

def _refused(A, args=(), pc_type="gamg"):
    ptt.init(args=["-ksp_type", "cg", "-pc_type", pc_type, *args], device="cpu")
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    ksp.setUp()


def _aij(pkg=ptt, **attrs):
    A = pkg.MatAIJ.from_scipy(poisson2d(8))
    for k, v in attrs.items():
        setattr(A, k, v)
    return A


def _block_layout(A):
    A.row_layout = A.row_layout.__class__(A.row_layout.N, bs=2)
    return A


# name: (make(pkg), options, PC type, the ROADMAP item that brings it, or
# None where a later slice has ported it: then the port solves as the
# reference does)
REFUSALS = {
    "classical": (_aij, ("-pc_gamg_type", "classical"), "gamg", None),
    # geo reads the PC's coordinates (PCSetCoordinates): the 8 x 8 grid's
    "geo": (lambda pkg: _aij(pkg, _pc_coords=np.stack(np.meshgrid(
        np.arange(8.0), np.arange(8.0), indexing="ij"), axis=-1).reshape(-1, 2)),
        ("-pc_gamg_type", "geo"), "gamg", None),
    "two_vector_nullspace": (lambda pkg: _aij(pkg, near_nullspace=np.ones((64, 2))), (),
                             "gamg", None),
    "block_size_2": (lambda pkg: _block_layout(_aij(pkg)), (), "gamg", None),
    "strength_index": (_aij, ("-pc_gamg_mat_coarsen_strength_index", "0"), "gamg", None),
    "asm_use_agg": (_aij, ("-pc_gamg_asm_use_agg",), "gamg", None),
    "hmg_block_system": (lambda pkg: _block_layout(_aij(pkg)), (), "hmg", None),
}


def _solve_as(pkg, make, args, pc_type):
    opts = ["-ksp_type", "cg", "-pc_type", pc_type, "-ksp_rtol", "1e-8", *args]
    if pkg is ptt:
        ptt.init(args=opts, device="cpu")
    else:
        pt_jax.init(args=opts)
    A = make(pkg)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    if hasattr(A, "_pc_coords"):
        ksp.getPC().setCoordinates(A._pc_coords)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    return ksp.getIterationNumber(), ksp.getConvergedReason().name, \
        np.asarray(ksp.getConvergenceHistory())


@pytest.mark.parametrize("name", REFUSALS)
def test_what_later_slices_bring_is_refused(name):
    make, args, pc_type, item = REFUSALS[name]
    if item is None:
        # ported with the block systems of item 7: the reference's solve
        its, reason, hist = _solve_as(ptt, make, args, pc_type)
        its_j, reason_j, hist_j = _solve_as(pt_jax, make, args, pc_type)
        assert (its, reason) == (its_j, reason_j) and reason == "CONVERGED_RTOL"
        # 1e-6 relative, where an entry is above rounding (1e-12 of the first)
        assert np.all(np.abs(hist - hist_j) <= 1e-6 * np.maximum(hist_j, 1e-6 * hist_j[0]))
        return
    ptt.init(device="cpu")
    A = make(ptt)
    with pytest.raises(NotImplementedError, match=item):
        _refused(A, args, pc_type)


def _lifted(pkg, sb, make):
    """CG+GAMG on make(pkg, sb), as a refused operator once was: (its, reason,
    history, rows per level, A kinds)."""
    args = ["-ksp_type", "cg", "-pc_type", "gamg", "-ksp_rtol", "1e-8"]
    if pkg is ptt:
        ptt.init(args=args, device="cpu")
    else:
        pt_jax.init(args=args)
    A = make(pkg, sb)
    ksp = pkg.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    x = A.createVecRight()
    ksp.solve(b, x)
    levels = ksp.getPC()._impl.levels
    return (ksp.getIterationNumber(), ksp.getConvergedReason().name,
            ksp.getConvergenceHistory(), [lev.A.getSize()[0] for lev in levels],
            ["aij_dnd" if lev.A.meta[0] == "aij_dnd" else "other" for lev in levels])


def _grid_aij(pkg, sb):
    A = pkg.MatAIJ.from_scipy(poisson2d(8))
    A.setStencilGrid((8, 8))
    return A


LIFTED = {
    # once refused naming item 5c (the structured head), now its parity
    "stencil_mat": lambda pkg, sb: sb.as_mat(*sb.build_dnd((6,) * 3, kind="box")),
    "grid_declared": _grid_aij,
}


@pytest.mark.parametrize("name", LIFTED)
def test_what_the_structured_head_brought_matches_the_reference(name):
    """A stencil Mat and a MatAIJ on a declared grid take the structured
    head (below its limit of 3000 rows the head makes no level and hands
    the fine operator to the aggregation as CSR): the reference's its,
    reason, history and hierarchy."""
    from petsc_tpu.ops import stencil_build as sb_jax
    got = _lifted(ptt, stencil_build, LIFTED[name])
    want = _lifted(pt_jax, sb_jax, LIFTED[name])
    assert got[0] == want[0] and got[1] == want[1] == "CONVERGED_RTOL"
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
    assert got[3:] == want[3:] and got[4][0] == "aij_dnd"


def test_hmg_on_a_scalar_operator_is_gamg():
    kp, _ = _gamg_ksp(ptt, BOX[16])
    ptt.init(args=["-ksp_type", "cg", "-pc_type", "hmg", "-ksp_rtol", "1e-8"], device="cpu")
    A = ptt.MatAIJ.from_scipy(BOX[16])
    ksp = ptt.KSP().create()
    ksp.setOperators(A)
    ksp.setFromOptions()
    b = A.createVecLeft()
    b.set(1.0)
    ksp.solve(b)
    assert ksp.getIterationNumber() == 8
    assert [lev.A.nnz() for lev in ksp.getPC()._impl.levels] == \
        [lev.A.nnz() for lev in kp.getPC()._impl.levels]
