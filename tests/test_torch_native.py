"""petsc_tpu_torch.native, the port's own build of graphops.cpp: the
sparse product, transpose and matvec of the Galerkin setup against scipy
and against the reference's native library, the copy's kernels verbatim
as the reference has them (the GAMG coarsening kernels are held against
the reference in tests/test_torch_gamg.py), and the loader's refusal to
run on without a compiler.

Tolerances: the port's copy of the C++ is the reference's, so results
equal the reference's bit for bit; against scipy (which sums in another
order) 1e-12 relative."""

import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsc_tpu import native as native_jax
from petsc_tpu_torch import native
from petsc_tpu_torch.sys.error import Error

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _pair(index_dtype):
    A = sp.random(257, 301, density=0.04, format="csr", random_state=7)
    B = sp.random(301, 129, density=0.05, format="csr", random_state=8)
    for M in (A, B):
        M.indptr = M.indptr.astype(index_dtype)
        M.indices = M.indices.astype(index_dtype)
    return A, B


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _same(C, R):
    assert C.shape == R.shape
    assert np.array_equal(C.indptr, R.indptr) and np.array_equal(C.indices, R.indices)
    assert np.array_equal(C.data, R.data)


@pytest.mark.parametrize("index_dtype", (np.int32, np.int64))
def test_spgemm_matches_scipy_and_the_reference(index_dtype):
    A, B = _pair(index_dtype)
    assert A.indices.dtype == index_dtype          # the kernel's int32 or int64 entry point
    C = native.spgemm(A, B)
    assert C.has_sorted_indices
    ref = (A @ B).tocsr()
    ref.sort_indices()
    assert _rel(C.toarray(), ref.toarray()) <= 1e-12
    _same(C, native_jax.spgemm(A, B))


@pytest.mark.parametrize("index_dtype", (np.int32, np.int64))
def test_csr_transpose_matches_scipy_and_the_reference(index_dtype):
    A, _ = _pair(index_dtype)
    T = native.csr_transpose(A)
    assert T.shape == (301, 257) and T.has_sorted_indices
    assert np.array_equal(T.toarray(), A.T.toarray())
    _same(T, native_jax.csr_transpose(A))


@pytest.mark.parametrize("index_dtype", (np.int32, np.int64))
def test_csr_matvec_matches_scipy_and_the_reference(index_dtype):
    A, _ = _pair(index_dtype)
    x = np.random.default_rng(3).random(301)
    y = native.csr_matvec_op(A)(x)
    assert _rel(y, A @ x) <= 1e-12
    assert np.array_equal(y, native_jax.csr_matvec_op(A)(x))


def test_galerkin_product_matches_the_reference():
    """P^T (A P) on a 2-D Laplacian with a piecewise-constant P."""
    n = 20
    T = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1])
    A = (sp.kron(T, sp.eye(n)) + sp.kron(sp.eye(n), T)).tocsr()
    P = sp.csr_matrix((np.ones(n * n), (np.arange(n * n), np.arange(n * n) // 4)),
                      shape=(n * n, n * n // 4))
    C = native.spgemm(native.csr_transpose(P), native.spgemm(A, P))
    assert _rel(C.toarray(), (P.T @ A @ P).toarray()) <= 1e-12
    _same(C, native_jax.spgemm(native_jax.csr_transpose(P), native_jax.spgemm(A, P)))


_DEF = re.compile(r"^(?:template <[^\n]*\n)?(?:static )?(?:void|int64_t) (\w+)\(.*?\n}\n",
                  re.M | re.S)


def test_the_library_is_the_ports_own_build():
    native.lib()
    assert native.openmp is True
    built = list((REPO / "petsc_tpu_torch" / "_build").glob("native-*/libgraphops.so"))
    assert built
    src = (REPO / "petsc_tpu_torch" / "native" / "graphops.cpp").read_text()
    ref = (REPO / "petsc_tpu" / "native" / "graphops.cpp").read_text()
    # the kernels and their C entry points, each as the reference has it
    defs = {m.group(1): m.group(0) for m in _DEF.finditer(src)}
    assert sorted(defs) == sorted(
        [f"{k}{s}" for k in ("csr_transpose", "spgemm_count", "spgemm_fill", "csr_matvec",
                             "strength_sym", "mis2_aggregate")
         for s in ("", "_i32", "_t")] + ["mis_aggregate", "fix_aggregates", "hem_match",
                                          "ilu0", "levels", "iluk_symbolic", "rcm",
                                          "greedy_color", "hem_aggregate"])
    for name, body in defs.items():
        if name == "rcm":
            # the port's rcm repairs the reference's (a second pass visits
            # what the first leaves): held on results by the tests below
            assert "if (!visited[v]) bfs(v);" in body
            continue
        assert body in ref, name
    meps = [ln for ln in src.splitlines() if ln.startswith("static const double HEM_MEPS")]
    assert len(meps) == 1 and meps[0] in ref


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(Error, match="building graphops.cpp failed with -fopenmp"):
        native.lib()
    assert native._lib is None


@pytest.mark.parametrize("refusal", (
    "cxx: error: unrecognized command-line option '-fopenmp'",
    "cxx: fatal error: cannot read spec file 'libgomp.spec': No such file or directory"))
def test_a_refused_openmp_flag_builds_serially_and_says_so(monkeypatch, tmp_path, refusal):
    """A compiler that refuses -fopenmp, or has no OpenMP runtime, gets the
    serial build, with a warning; any other failure raises (the test
    above)."""
    cxx = tmp_path / "cxx"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                   f'{{ echo "{refusal}" >&2; exit 1; }}; done\nexec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "openmp", None)
    monkeypatch.setattr(native, "build_seconds", None)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.warns(UserWarning, match="refused -fopenmp"):
        L = native.lib()
    assert native.openmp is False and native.build_seconds > 0
    assert len(list((tmp_path / "build").glob("native-*/libgraphops.so"))) == 1
    # a later process takes the serial library without asking the compiler again
    native._lib = native.build_seconds = None
    monkeypatch.setenv("CXX", "false")
    with pytest.warns(UserWarning, match="found by an earlier build"):
        native.lib()
    assert native.openmp is False and native.build_seconds is None
    A, B = _pair(np.int32)
    n = A.shape[0]
    Ci = np.empty(n + 1, dtype=np.int64)
    nnz = L.spgemm_count_i32(n, B.shape[1], A.indptr, A.indices, B.indptr, B.indices, Ci)
    assert nnz == (A @ B).nnz


def _ilu_matrix():
    """A non-symmetric, diagonally dominant CSR with sorted columns."""
    n = 200
    R = sp.random(n, n, density=0.03, format="csr", random_state=9)
    A = (R + sp.diags(np.full(n, 6.0))).tocsr()
    A.sort_indices()
    return A


def test_ilu0_levels_and_iluk_symbolic_equal_the_reference():
    A = _ilu_matrix()
    assert np.array_equal(native.ilu0_inplace(A.indptr, A.indices, A.data),
                          native_jax.ilu0_inplace(A.indptr, A.indices, A.data))
    L = sp.tril(A, k=-1).tocsr()
    U = sp.triu(A, k=1).tocsr()
    for T, lower in ((L, True), (U, False)):
        lev, nlev = native.levels(T.indptr, T.indices, lower)
        lev_r, nlev_r = native_jax.levels(T.indptr, T.indices, lower)
        assert nlev == nlev_r and np.array_equal(lev, lev_r)
    for k in (1, 2, 3):
        for a, b in zip(native.iluk_symbolic(A.indptr, A.indices, k),
                        native_jax.iluk_symbolic(A.indptr, A.indices, k)):
            assert np.array_equal(a, b)


def test_ilu0_on_a_tridiagonal_matrix_is_its_exact_lu():
    n = 50
    T = sp.diags([np.full(n - 1, -1.0), np.full(n, 3.0), np.full(n - 1, -0.5)],
                 [-1, 0, 1]).tocsr()
    v = native.ilu0_inplace(T.indptr, T.indices, T.data)
    F = sp.csr_matrix((v, T.indices, T.indptr), shape=T.shape)
    Lf = sp.tril(F, k=-1) + sp.eye(n)
    Uf = sp.triu(F)
    assert _rel((Lf @ Uf).toarray(), T.toarray()) <= 1e-14


def test_a_zero_pivot_in_ilu0_raises_naming_the_row():
    A = sp.csr_matrix(np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 2.0]]))
    with pytest.raises(Error, match="zero pivot in row 1"):
        native.ilu0_inplace(A.indptr, A.indices, A.data)


def _is_permutation(p, n):
    return len(p) == n and np.array_equal(np.sort(p), np.arange(n))


def test_rcm_of_a_single_entry_matrix_is_a_permutation():
    """The reference's loop leaves every vertex but the root unvisited on a
    4096 x 4096 CSR whose only entry is (0, 0) (its perm reads past the end
    of its order); the port's second pass visits them all."""
    n = 4096
    A = sp.csr_matrix(([1.0], ([0], [0])), shape=(n, n))
    perm = native.rcm(A.indptr.astype(np.int64), A.indices.astype(np.int64))
    assert _is_permutation(perm, n)
    import petsc_tpu_torch as pt
    from petsc_tpu_torch.mat import order
    pt.init(args=[], device="cpu")
    for p in order.get_ordering(pt.MatAIJ.from_scipy(A), "rcm"):
        assert _is_permutation(p, n)


@pytest.mark.parametrize("seed", range(6))
def test_rcm_is_a_permutation_on_graphs_of_many_components(seed):
    """Seeded random graphs of several components and isolated vertices:
    the port's rcm is a permutation, and equals the reference's wherever
    the reference's is one."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 400))
    blocks, off = [], 0
    while off < n:
        k = int(min(n - off, rng.integers(1, 60)))
        if k > 1 and rng.random() < 0.8:
            B = sp.random(k, k, density=min(1.0, 3.0 / k), random_state=int(rng.integers(1 << 30)))
            B = B + B.T
        else:
            B = sp.csr_matrix((k, k))         # isolated vertices
        blocks.append(B)
        off += k
    G = sp.block_diag(blocks, format="csr")
    p = rng.permutation(n)
    G = G[p][:, p].tocsr()
    G.sort_indices()
    ip, ix = G.indptr.astype(np.int64), G.indices.astype(np.int64)
    perm = native.rcm(ip, ix)
    assert _is_permutation(perm, n)
    ref = native_jax.rcm(ip, ix)
    if _is_permutation(ref, n):
        assert np.array_equal(perm, ref)
