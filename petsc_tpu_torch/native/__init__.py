"""Native (C++) host kernels of the setup phase, built at first use.

Counterpart of ``petsc_tpu/native/__init__.py``. The port keeps its own
copy of ``graphops.cpp`` beside this module and builds it with
``g++ -O2 -fopenmp`` (without ``-fopenmp`` only where the compiler
refuses the flag) into ``petsc_tpu_torch/_build/native-<hash>/``, keyed
by the source and flags, so that a changed source never loads a stale
library. Nothing is built when a module is imported. Unlike the
reference there is no numpy fallback: a failed build raises with the
compiler's output. A fall-back to the serial build happens only when the
compiler's own output names the OpenMP flag or its runtime, and is
announced with a warning and recorded in :data:`openmp`.

Bound here: what the Galerkin setup of PCMG needs (``spgemm``,
``csr_transpose``, ``csr_matvec_op``), the coarsening of PCGAMG
(``strength_sym``, ``mis_aggregate``, ``mis2_aggregate``,
``fix_aggregates``, ``hem_match``), the factorizations of PCILU
(``ilu0_inplace``, ``iluk_symbolic``, ``levels``), and the Mat graph
operations (``rcm`` for MatGetOrdering, ``greedy_color`` for
MatFDColoring, the loose ``hem_aggregate``). Unlike the reference's
bindings, none returns None for a missing library: the build raises
instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

from ..sys.error import Error

_SRC = Path(__file__).resolve().parent / "graphops.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_BASE_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lib = None
build_seconds = None      # wall time of this process's build, None if loaded from disk
openmp = None             # whether the loaded library was built with -fopenmp
# what gcc or clang prints when it refuses -fopenmp, or lacks the OpenMP
# header or runtime (a gcc installed without libgomp: "cannot read spec
# file 'libgomp.spec'")
_OMP_REFUSED = ("-fopenmp", "omp.h: No such file", "'omp.h' file not found",
                "libgomp", "-lgomp", "-lomp")


def _library_path(flags) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"native-{h.hexdigest()[:16]}" / "libgraphops.so"


def _compile(flags, dest: Path):
    """Compile with `flags` into `dest` in one rename (a concurrent process
    never loads half a file); returns the compiler's result."""
    cxx = os.environ.get("CXX", "g++")
    dest.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dest.parent) as tmp:
        out = Path(tmp) / dest.name
        res = subprocess.run([cxx, *flags, str(_SRC), "-o", str(out)],
                             capture_output=True, text=True)
        if res.returncode == 0:
            os.replace(out, dest)
    return res


def _failed(what, res):
    return Error(f"petsc_tpu_torch.native: building graphops.cpp failed {what} "
                 f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")


def lib():
    """The loaded library, built from ``graphops.cpp`` on first use."""
    global _lib, build_seconds, openmp
    if _lib is not None:
        return _lib
    omp_flags = ("-fopenmp",) + _BASE_FLAGS
    omp_path, serial_path = _library_path(omp_flags), _library_path(_BASE_FLAGS)
    refused = "found by an earlier build"
    # a serial library is only ever built after the compiler refused the flag
    if not omp_path.exists() and not serial_path.exists():
        t0 = time.perf_counter()
        res = _compile(omp_flags, omp_path)
        if res.returncode != 0:
            if not any(k in res.stdout + res.stderr for k in _OMP_REFUSED):
                raise _failed("with -fopenmp", res)
            refused = res.stderr.strip()
            res = _compile(_BASE_FLAGS, serial_path)
            if res.returncode != 0:
                raise _failed("without -fopenmp", res)
        build_seconds = time.perf_counter() - t0
    with_omp = omp_path.exists()
    if not with_omp:
        warnings.warn(f"petsc_tpu_torch.native: the compiler refused -fopenmp ({refused}); "
                      "graphops.cpp runs serially", stacklevel=2)
    L = ctypes.CDLL(str(omp_path if with_omp else serial_path))
    i64, i32, f8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pf8 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    sigs = {
        "csr_transpose": (None, [i64, i64, p64, p64, pf8, p64, p64, pf8]),
        "csr_transpose_i32": (None, [i32, i32, p32, p32, pf8, p32, p32, pf8]),
        "spgemm_count": (i64, [i64, i64, p64, p64, p64, p64, p64]),
        "spgemm_count_i32": (i64, [i32, i32, p32, p32, p32, p32, p64]),
        "spgemm_fill": (None, [i64, i64, p64, p64, pf8, p64, p64, pf8, p64, p64, pf8]),
        "spgemm_fill_i32": (None, [i32, i32, p32, p32, pf8, p32, p32, pf8, p64, p32, pf8]),
        "csr_matvec": (None, [i64, p64, p64, pf8, pf8, pf8]),
        "csr_matvec_i32": (None, [i32, p32, p32, pf8, pf8, pf8]),
        "strength_sym": (i64, [i64, p64, p64, pf8, f8, p64, p64, pf8]),
        "strength_sym_i32": (i64, [i32, p32, p32, pf8, f8, p32, p32, pf8]),
        "mis_aggregate": (i64, [i64, p64, p64, p64, p64, p64]),
        "mis2_aggregate": (i64, [i64, p64, p64, p64, p64, p64]),
        "mis2_aggregate_i32": (i64, [i32, p32, p32, p64, p64, p64]),
        "fix_aggregates": (None, [i64, p64, p64, p64, i64, p64]),
        "hem_match": (i64, [i64, p64, p64, pf8, i64, f8, p64]),
        "ilu0": (i64, [i64, p64, p64, pf8]),
        "levels": (i64, [i64, p64, p64, i64, p64]),
        "iluk_symbolic": (i64, [i64, p64, p64, i64, ctypes.c_void_p, ctypes.c_void_p]),
        "rcm": (None, [i64, p64, p64, p64]),
        "greedy_color": (i64, [i64, p64, p64, p64]),
        "hem_aggregate": (i64, [i64, p64, p64, ctypes.c_void_p, i64, p64]),
    }
    for name, (res_t, args) in sigs.items():
        fn = getattr(L, name)
        fn.restype = res_t
        fn.argtypes = args
    _lib, openmp = L, with_omp
    return L


def _c64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _cf8(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _idx(A):
    """(indptr, indices, is32) without copies when already int32/int64."""
    ip, ix = A.indptr, A.indices
    if ip.dtype == np.int32 and ix.dtype == np.int32:
        return np.ascontiguousarray(ip), np.ascontiguousarray(ix), True
    return _c64(ip), _c64(ix), False


def spgemm(A, B):
    """C = A @ B for scipy CSRs through the OpenMP Gustavson kernel (count,
    then fill; matmatmult.c's numeric role). Returns a scipy CSR with
    sorted column indices."""
    import scipy.sparse as sp
    L = lib()
    n, m = A.shape[0], B.shape[1]
    Ai, Aj, a32 = _idx(A)
    Bi, Bj, b32 = _idx(B)
    Ax, Bx = _cf8(A.data), _cf8(B.data)
    Ci = np.empty(n + 1, dtype=np.int64)
    if a32 and b32:
        nnz = L.spgemm_count_i32(n, m, Ai, Aj, Bi, Bj, Ci)
        Cj = np.empty(nnz, dtype=np.int32)
        Cx = np.empty(nnz, dtype=np.float64)
        L.spgemm_fill_i32(n, m, Ai, Aj, Ax, Bi, Bj, Bx, Ci, Cj, Cx)
        Ci = Ci.astype(np.int32)
    else:
        Ai, Aj, Bi, Bj = _c64(Ai), _c64(Aj), _c64(Bi), _c64(Bj)
        nnz = L.spgemm_count(n, m, Ai, Aj, Bi, Bj, Ci)
        Cj = np.empty(nnz, dtype=np.int64)
        Cx = np.empty(nnz, dtype=np.float64)
        L.spgemm_fill(n, m, Ai, Aj, Ax, Bi, Bj, Bx, Ci, Cj, Cx)
    C = sp.csr_matrix((Cx, Cj, Ci), shape=(n, m))
    C.has_sorted_indices = True
    return C


def csr_transpose(A):
    """A^T of a scipy CSR as a scipy CSR (counting-sort transpose; the
    columns of each row come out sorted)."""
    import scipy.sparse as sp
    L = lib()
    n, m = A.shape
    Ai, Aj, is32 = _idx(A)
    it = np.int32 if is32 else np.int64
    Bi = np.empty(m + 1, dtype=it)
    Bj = np.empty(A.nnz, dtype=it)
    Bx = np.empty(A.nnz, dtype=np.float64)
    (L.csr_transpose_i32 if is32 else L.csr_transpose)(n, m, Ai, Aj, _cf8(A.data), Bi, Bj, Bx)
    B = sp.csr_matrix((Bx, Bj, Bi), shape=(m, n))
    B.has_sorted_indices = True
    return B


def csr_matvec_op(A):
    """y = A @ x for a scipy CSR, as a closure over the OpenMP row-parallel
    matvec (for the host Arnoldi eigenvalue estimate)."""
    L = lib()
    n = A.shape[0]
    Ai, Aj, is32 = _idx(A)
    Ax = _cf8(A.data)
    fn = L.csr_matvec_i32 if is32 else L.csr_matvec

    def mv(x):
        y = np.empty(n, dtype=np.float64)
        fn(n, Ai, Aj, Ax, _cf8(x), y)
        return y

    return mv


def strength_sym(A, threshold):
    """The strength graph G = |A| + |A|^T of a square scipy CSR, entries
    with |g_ij| <= threshold * sqrt(g_ii g_jj) dropped (threshold < 0
    keeps all; the diagonal always stays), as a scipy CSR with sorted
    columns (agg.c:752, bs = 1)."""
    import scipy.sparse as sp
    L = lib()
    n = A.shape[0]
    Ai, Aj, is32 = _idx(A)
    it = np.int32 if is32 else np.int64
    Gi = np.empty(n + 1, dtype=it)
    Gj = np.empty(2 * A.nnz, dtype=it)       # the worst case of |A| + |A|^T
    Gx = np.empty(2 * A.nnz, dtype=np.float64)
    nnz = (L.strength_sym_i32 if is32 else L.strength_sym)(
        n, Ai, Aj, _cf8(A.data), float(threshold), Gi, Gj, Gx)
    G = sp.csr_matrix((Gx[:nnz], Gj[:nnz], Gi), shape=(n, n))
    G.has_sorted_indices = True
    return G


def mis_aggregate(indptr, indices, perm):
    """Greedy MIS aggregation of a graph, vertices visited in `perm`
    order: (agg, nagg, roots), agg[v] = -1 for a removed singleton."""
    n = len(indptr) - 1
    agg = np.empty(n, dtype=np.int64)
    roots = np.empty(max(n, 1), dtype=np.int64)
    nagg = lib().mis_aggregate(n, _c64(indptr), _c64(indices), _c64(perm), agg, roots)
    return agg, int(nagg), roots[:nagg].copy()


def mis2_aggregate(indptr, indices, perm):
    """MIS aggregation on the implicit square of a graph: the greedy
    semantics of mis_aggregate on G^2 without forming G^2. Returns
    (agg, nagg, roots)."""
    L = lib()
    n = len(indptr) - 1
    agg = np.empty(n, dtype=np.int64)
    roots = np.empty(max(n, 1), dtype=np.int64)
    if indptr.dtype == np.int32 and indices.dtype == np.int32:
        nagg = L.mis2_aggregate_i32(n, np.ascontiguousarray(indptr),
                                    np.ascontiguousarray(indices), _c64(perm), agg, roots)
    else:
        nagg = L.mis2_aggregate(n, _c64(indptr), _c64(indices), _c64(perm), agg, roots)
    return agg, int(nagg), roots[:nagg].copy()


def fix_aggregates(indptr, indices, roots, agg):
    """The square fix-up: every root takes its direct non-root neighbours
    into its aggregate. Returns the new agg (int64; agg itself is updated
    in place when it is already a contiguous int64 array)."""
    agg = np.ascontiguousarray(agg, dtype=np.int64)
    lib().fix_aggregates(len(indptr) - 1, _c64(indptr), _c64(indices), _c64(roots),
                         len(roots), agg)
    return agg


def hem_match(indptr, indices, weights, rounds, threshold):
    """Exact serial heavy-edge matching (hem.c) on the SCALED strength
    graph (unit diagonal): edge-sorted matching with max-edge gating,
    boundary rows pooled, each round contracted and rescaled. Returns
    (agg, nagg)."""
    n = len(indptr) - 1
    agg = np.empty(n, dtype=np.int64)
    nagg = lib().hem_match(n, _c64(indptr), _c64(indices), _cf8(weights), int(rounds),
                           float(threshold), agg)
    return agg, int(nagg)


def ilu0_inplace(indptr, indices, vals):
    """The in-pattern ILU(0) factors of a column-sorted CSR with every
    diagonal present, as a new float64 array of values: L strictly below
    the diagonal (unit diagonal implied), D + U on and above it. Raises
    ``Error`` on a zero pivot or a missing diagonal, naming the row."""
    v = np.array(vals, dtype=np.float64)
    err = lib().ilu0(len(indptr) - 1, _c64(indptr), _c64(indices), v)
    if err != 0:
        raise Error(f"ILU(0): zero pivot in row {-err - 1}")
    return v


def levels(indptr, indices, lower):
    """Dependency levels of a strictly triangular CSR: (lev, nlevels),
    lev[i] one more than the deepest level among row i's columns (rows
    in forward order when `lower`, else backward)."""
    n = len(indptr) - 1
    lev = np.zeros(n, dtype=np.int64)
    nlev = lib().levels(n, _c64(indptr), _c64(indices), 1 if lower else 0, lev)
    return lev, int(nlev)


def iluk_symbolic(indptr, indices, k):
    """The ILU(k) level-of-fill pattern of a CSR, rows column-sorted and
    every diagonal present: (indptr, indices), int64."""
    L = lib()
    n = len(indptr) - 1
    ip, ix = _c64(indptr), _c64(indices)
    nnz = L.iluk_symbolic(n, ip, ix, int(k), None, None)
    out_ip = np.empty(n + 1, dtype=np.int64)
    out_ix = np.empty(int(nnz), dtype=np.int64)
    L.iluk_symbolic(n, ip, ix, int(k), out_ip.ctypes.data_as(ctypes.c_void_p),
                    out_ix.ctypes.data_as(ctypes.c_void_p))
    return out_ip, out_ix


def rcm(indptr, indices):
    """The reverse Cuthill-McKee ordering of a graph's CSR pattern:
    perm[new] = old (genrcm.c's role)."""
    n = len(indptr) - 1
    perm = np.empty(n, dtype=np.int64)
    lib().rcm(n, _c64(indptr), _c64(indices), perm)
    return perm


def greedy_color(indptr, indices):
    """Greedy distance-1 colouring of an adjacency CSR in vertex order."""
    n = len(indptr) - 1
    colors = np.empty(n, dtype=np.int64)
    lib().greedy_color(n, _c64(indptr), _c64(indices), colors)
    return colors


def hem_aggregate(indptr, indices, weights, rounds):
    """Heavy-edge-matching aggregation, `rounds` rounds of matching on the
    contracted graph (|weights|, or 1 per edge when weights is None):
    (agg, nagg)."""
    n = len(indptr) - 1
    agg = np.empty(n, dtype=np.int64)
    w = None if weights is None else _cf8(weights)
    nagg = lib().hem_aggregate(n, _c64(indptr), _c64(indices),
                               w.ctypes.data_as(ctypes.c_void_p) if w is not None else None,
                               int(rounds), agg)
    return agg, int(nagg)
