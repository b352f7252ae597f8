// Native host kernels of the multigrid setup for petsc_tpu_torch.
//
// The port's own copy of the host kernels of petsc_tpu/native/graphops.cpp
// that the PCMG and PCGAMG setups call, each as the reference has it:
// * the Galerkin products: the scalable PtAP of mpiptap.c:215 as a
//   Gustavson count+fill SpGEMM, the transpose that forms R = P^T, and
//   the row-parallel matvec of the host Arnoldi eigenvalue estimate;
// * the smoothed-aggregation coarsening of PCGAMG: the strength graph
//   |A| + |A|^T with its threshold filter (agg.c:752), greedy MIS
//   aggregation (mis.c:89-207) on the graph and on its implicit square,
//   the square fix-up (agg.c:913 fixAggregatesWithSquare) and the exact
//   serial heavy-edge matching (hem.c).
// * the factorizations of PCILU and the level schedule of its triangular
//   solves: in-pattern ILU(0) (aijfact.c:216), the ILU(k) level-of-fill
//   pattern (aijfact.c:1536) and the dependency levels of a triangular
//   CSR (petsc_tpu_torch/ops/trisolve.py).
// * the orderings and colourings of the Mat graph operations: reverse
//   Cuthill-McKee (genrcm.c), the greedy colouring of MatFDColoring and
//   the loose heavy-edge-matching aggregation.
// Exposed with C linkage for ctypes; petsc_tpu_torch/native/__init__.py
// builds it at first use. There is no numpy fallback: a failed build
// raises.
//
// Templated over the index type so scipy's native int32 arrays pass
// through without conversion copies (the int64 instantiations serve
// matrices past 2^31 entries).
//
// Build: g++ -O2 -fopenmp -shared -fPIC -std=c++17 graphops.cpp -o libgraphops.so

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <queue>
#include <algorithm>
#ifdef _OPENMP
#include <omp.h>
#endif

template <class I>
static void csr_transpose_t(I n, I ncols, const I* Ai, const I* Aj,
                            const double* Ax, I* Bi, I* Bj, double* Bx) {
  I nnz = Ai[n];
  std::vector<I> cnt(ncols + 1, 0);
  for (I p = 0; p < nnz; p++) cnt[Aj[p] + 1]++;
  for (I c = 0; c < ncols; c++) cnt[c + 1] += cnt[c];
  for (I c = 0; c <= ncols; c++) Bi[c] = cnt[c];
  std::vector<I> pos(cnt.begin(), cnt.end() - 1);
  for (I i = 0; i < n; i++)
    for (I p = Ai[i]; p < Ai[i + 1]; p++) {
      I q = pos[Aj[p]]++;
      Bj[q] = i;
      if (Bx && Ax) Bx[q] = Ax[p];
    }
}

template <class I>
static int64_t spgemm_count_t(I n, I m, const I* Ai, const I* Aj,
                              const I* Bi, const I* Bj, int64_t* Ci) {
  std::vector<int64_t> rownnz(n);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<I> mark(m, (I)-1);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 512)
#endif
    for (I i = 0; i < n; i++) {
      int64_t c = 0;
      for (I p = Ai[i]; p < Ai[i + 1]; p++) {
        I k = Aj[p];
        for (I q = Bi[k]; q < Bi[k + 1]; q++) {
          I j = Bj[q];
          if (mark[j] != i) { mark[j] = i; c++; }
        }
      }
      rownnz[i] = c;
    }
  }
  Ci[0] = 0;
  for (I i = 0; i < n; i++) Ci[i + 1] = Ci[i] + rownnz[i];
  return Ci[n];
}

// Numeric phase (Gustavson, per-thread dense accumulator); rows come out
// column-sorted. Ci (int64) from spgemm_count; Cj in the OUTPUT index
// type J (int32 when the result fits, independent of the input width).
template <class I, class J>
static void spgemm_fill_t(I n, I m, const I* Ai, const I* Aj,
                          const double* Ax, const I* Bi, const I* Bj,
                          const double* Bx, const int64_t* Ci, J* Cj,
                          double* Cx) {
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<double> acc(m, 0.0);
    std::vector<I> mark(m, (I)-1);
    std::vector<I> cols;
    cols.reserve(1024);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 512)
#endif
    for (I i = 0; i < n; i++) {
      cols.clear();
      for (I p = Ai[i]; p < Ai[i + 1]; p++) {
        I k = Aj[p];
        double a = Ax[p];
        for (I q = Bi[k]; q < Bi[k + 1]; q++) {
          I j = Bj[q];
          if (mark[j] != i) {
            mark[j] = i;
            acc[j] = a * Bx[q];
            cols.push_back(j);
          } else {
            acc[j] += a * Bx[q];
          }
        }
      }
      std::sort(cols.begin(), cols.end());
      int64_t pos = Ci[i];
      for (I j : cols) { Cj[pos] = (J)j; Cx[pos] = acc[j]; pos++; }
    }
  }
}

// Strength graph G = |A| + |A|^T with threshold filtering (agg.c:752,
// bs=1): drop |g_ij| <= threshold * sqrt(g_ii g_jj) (threshold < 0 keeps
// all); the diagonal is never dropped. Single call: caller allocates the
// worst-case 2*nnz(A) output; returns the actual nnz.
template <class I>
static int64_t strength_sym_t(I n, const I* Ai, const I* Aj,
                              const double* Ax, double threshold, I* Gi,
                              I* Gj, double* Gx) {
  I nnz = Ai[n];
  std::vector<I> Ti(n + 1), Tj(nnz);
  std::vector<double> Tx(nnz);
  csr_transpose_t<I>(n, n, Ai, Aj, Ax, Ti.data(), Tj.data(), Tx.data());
  std::vector<double> dg(n, 0.0);
  const bool filt = threshold >= 0.0;
  if (filt) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (I i = 0; i < n; i++)
      for (I p = Ai[i]; p < Ai[i + 1]; p++)
        if (Aj[p] == i) { dg[i] = std::sqrt(2.0 * std::fabs(Ax[p])); break; }
  }
  // padded per-row slots sized (rowA + rowT), then compact
  std::vector<int64_t> off(n + 1), cnt(n);
  off[0] = 0;
  for (I i = 0; i < n; i++)
    off[i + 1] = off[i] + (Ai[i + 1] - Ai[i]) + (Ti[i + 1] - Ti[i]);
  // off[n] == 2*nnz == caller's allocation; write row i at off[i]
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 512)
#endif
  for (I i = 0; i < n; i++) {
    I pa = Ai[i], ea = Ai[i + 1];
    I pt = Ti[i], et = Ti[i + 1];
    int64_t w = off[i];
    while (pa < ea || pt < et) {
      I ja = pa < ea ? Aj[pa] : n;
      I jt = pt < et ? Tj[pt] : n;
      I j;
      double v;
      if (ja == jt) { j = ja; v = std::fabs(Ax[pa]) + std::fabs(Tx[pt]);
                      pa++; pt++; }
      else if (ja < jt) { j = ja; v = std::fabs(Ax[pa]); pa++; }
      else { j = jt; v = std::fabs(Tx[pt]); pt++; }
      if (filt && j != i && v <= threshold * dg[i] * dg[j]) continue;
      Gj[w] = j; Gx[w] = v; w++;
    }
    cnt[i] = w - off[i];
  }
  // serial left-compaction (memmove-safe: targets never pass sources)
  Gi[0] = 0;
  int64_t pos = 0;
  for (I i = 0; i < n; i++) {
    if (pos != off[i] && cnt[i]) {
      std::memmove(Gj + pos, Gj + off[i], cnt[i] * sizeof(I));
      std::memmove(Gx + pos, Gx + off[i], cnt[i] * sizeof(double));
    }
    pos += cnt[i];
    Gi[i + 1] = (I)pos;
  }
  return pos;
}

// MIS aggregation on the IMPLICIT squared graph (the aggressive-
// coarsening path, agg.c:1254 square + mis): identical greedy semantics
// to mis_aggregate(G^2, perm) — visit in perm order, an undecided vertex
// roots and captures every undecided vertex within distance <= 2 — but
// G^2 (~5x the nnz at 27-point) is never materialized. Distance-2
// expansion only runs for vertices still undecided at visit time
// (~nagg of them), so this is O(nagg * deg^2) not O(n * deg^2).
template <class I>
static int64_t mis2_aggregate_t(I n, const I* indptr, const I* indices,
                                const int64_t* perm, int64_t* agg,
                                int64_t* roots_out) {
  for (I i = 0; i < n; i++) agg[i] = -2;
  std::vector<I> stamp(n, (I)-1);
  std::vector<I> nbrs2;
  nbrs2.reserve(4096);
  int64_t nagg = 0;
  for (I kk = 0; kk < n; kk++) {
    I v = (I)perm[kk];
    if (agg[v] != -2) continue;
    nbrs2.clear();
    for (I p = indptr[v]; p < indptr[v + 1]; p++) {
      I k = indices[p];
      for (I q = indptr[k]; q < indptr[k + 1]; q++) {
        I j = indices[q];
        if (stamp[j] != v) { stamp[j] = v; nbrs2.push_back(j); }
      }
    }
    if ((int64_t)nbrs2.size() < 2) { agg[v] = -1; continue; }  // singleton
    agg[v] = nagg;
    for (I j : nbrs2)
      if (agg[j] == -2) agg[j] = nagg;
    roots_out[nagg++] = v;
  }
  for (I i = 0; i < n; i++)
    if (agg[i] == -2) agg[i] = -1;
  return nagg;
}

template <class I>
static void csr_matvec_t(I n, const I* Ai, const I* Aj, const double* Ax,
                         const double* x, double* y) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (I i = 0; i < n; i++) {
    double s = 0.0;
    for (I p = Ai[i]; p < Ai[i + 1]; p++) s += Ax[p] * x[Aj[p]];
    y[i] = s;
  }
}

extern "C" {

// Greedy MIS aggregation over `perm` order (mis.c:89-207 serial
// strict-aggs semantics). agg must be length n; returns nagg. roots_out
// (length n capacity) receives root vertex of each aggregate.
int64_t mis_aggregate(int64_t n, const int64_t* indptr,
                      const int64_t* indices, const int64_t* perm,
                      int64_t* agg, int64_t* roots_out) {
  for (int64_t i = 0; i < n; i++) agg[i] = -2;
  int64_t nagg = 0;
  for (int64_t k = 0; k < n; k++) {
    int64_t v = perm[k];
    if (agg[v] != -2) continue;
    int64_t lo = indptr[v], hi = indptr[v + 1];
    if (hi - lo < 2) { agg[v] = -1; continue; }  // singleton: removed
    agg[v] = nagg;
    for (int64_t p = lo; p < hi; p++) {
      int64_t j = indices[p];
      if (agg[j] == -2) agg[j] = nagg;
    }
    roots_out[nagg++] = v;
  }
  for (int64_t i = 0; i < n; i++)
    if (agg[i] == -2) agg[i] = -1;
  return nagg;
}

// Post-MIS(G^2) fixup (agg.c:913): every root steals its direct
// (unsquared-graph) non-root neighbors into its own aggregate.
void fix_aggregates(int64_t n, const int64_t* indptr,
                    const int64_t* indices, const int64_t* roots,
                    int64_t nroots, int64_t* agg) {
  std::vector<uint8_t> is_root(n, 0);
  for (int64_t a = 0; a < nroots; a++) is_root[roots[a]] = 1;
  for (int64_t a = 0; a < nroots; a++) {
    int64_t r = roots[a];
    for (int64_t p = indptr[r]; p < indptr[r + 1]; p++) {
      int64_t j = indices[p];
      if (!is_root[j]) agg[j] = a;
    }
  }
  for (int64_t a = 0; a < nroots; a++) agg[roots[a]] = a;
}

void csr_transpose(int64_t n, int64_t ncols, const int64_t* Ai,
                   const int64_t* Aj, const double* Ax, int64_t* Bi,
                   int64_t* Bj, double* Bx) {
  csr_transpose_t<int64_t>(n, ncols, Ai, Aj, Ax, Bi, Bj, Bx);
}
void csr_transpose_i32(int32_t n, int32_t ncols, const int32_t* Ai,
                       const int32_t* Aj, const double* Ax, int32_t* Bi,
                       int32_t* Bj, double* Bx) {
  csr_transpose_t<int32_t>(n, ncols, Ai, Aj, Ax, Bi, Bj, Bx);
}

int64_t spgemm_count(int64_t n, int64_t m, const int64_t* Ai,
                     const int64_t* Aj, const int64_t* Bi,
                     const int64_t* Bj, int64_t* Ci) {
  return spgemm_count_t<int64_t>(n, m, Ai, Aj, Bi, Bj, Ci);
}
int64_t spgemm_count_i32(int32_t n, int32_t m, const int32_t* Ai,
                         const int32_t* Aj, const int32_t* Bi,
                         const int32_t* Bj, int64_t* Ci) {
  return spgemm_count_t<int32_t>(n, m, Ai, Aj, Bi, Bj, Ci);
}

void spgemm_fill(int64_t n, int64_t m, const int64_t* Ai, const int64_t* Aj,
                 const double* Ax, const int64_t* Bi, const int64_t* Bj,
                 const double* Bx, const int64_t* Ci, int64_t* Cj,
                 double* Cx) {
  spgemm_fill_t<int64_t, int64_t>(n, m, Ai, Aj, Ax, Bi, Bj, Bx, Ci, Cj, Cx);
}
void spgemm_fill_i32(int32_t n, int32_t m, const int32_t* Ai,
                     const int32_t* Aj, const double* Ax, const int32_t* Bi,
                     const int32_t* Bj, const double* Bx, const int64_t* Ci,
                     int32_t* Cj, double* Cx) {
  spgemm_fill_t<int32_t, int32_t>(n, m, Ai, Aj, Ax, Bi, Bj, Bx, Ci, Cj, Cx);
}

int64_t strength_sym(int64_t n, const int64_t* Ai, const int64_t* Aj,
                     const double* Ax, double threshold, int64_t* Gi,
                     int64_t* Gj, double* Gx) {
  return strength_sym_t<int64_t>(n, Ai, Aj, Ax, threshold, Gi, Gj, Gx);
}
int64_t strength_sym_i32(int32_t n, const int32_t* Ai, const int32_t* Aj,
                         const double* Ax, double threshold, int32_t* Gi,
                         int32_t* Gj, double* Gx) {
  return strength_sym_t<int32_t>(n, Ai, Aj, Ax, threshold, Gi, Gj, Gx);
}

int64_t mis2_aggregate(int64_t n, const int64_t* indptr,
                       const int64_t* indices, const int64_t* perm,
                       int64_t* agg, int64_t* roots_out) {
  return mis2_aggregate_t<int64_t>(n, indptr, indices, perm, agg, roots_out);
}
int64_t mis2_aggregate_i32(int32_t n, const int32_t* indptr,
                           const int32_t* indices, const int64_t* perm,
                           int64_t* agg, int64_t* roots_out) {
  return mis2_aggregate_t<int32_t>(n, indptr, indices, perm, agg, roots_out);
}

void csr_matvec(int64_t n, const int64_t* Ai, const int64_t* Aj,
                const double* Ax, const double* x, double* y) {
  csr_matvec_t<int64_t>(n, Ai, Aj, Ax, x, y);
}
void csr_matvec_i32(int32_t n, const int32_t* Ai, const int32_t* Aj,
                    const double* Ax, const double* x, double* y) {
  csr_matvec_t<int32_t>(n, Ai, Aj, Ax, x, y);
}

// In-pattern ILU(0) numeric factorization (aijfact.c:216 algorithm):
// vals modified in place to hold L (strict lower, unit diag implied) and
// U (diag + strict upper). Returns -row-1 on zero pivot, 0 on success.
// Requires column-sorted CSR with present diagonals.
int64_t ilu0(int64_t n, const int64_t* indptr, const int64_t* indices,
             double* vals) {
  std::vector<int64_t> diag(n);
  std::vector<int64_t> work(n, -1);  // col -> position in current row
  for (int64_t i = 0; i < n; i++) {
    diag[i] = -1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; p++)
      if (indices[p] == i) { diag[i] = p; break; }
    if (diag[i] < 0) return -i - 1;
  }
  for (int64_t i = 0; i < n; i++) {
    int64_t lo = indptr[i], hi = indptr[i + 1];
    for (int64_t p = lo; p < hi; p++) work[indices[p]] = p;
    for (int64_t p = lo; p < hi; p++) {
      int64_t k = indices[p];
      if (k >= i) break;
      double akk = vals[diag[k]];
      if (akk == 0.0) { for (int64_t q=lo;q<hi;q++) work[indices[q]]=-1;
                        return -k - 1; }
      double lik = vals[p] / akk;
      vals[p] = lik;
      for (int64_t q = diag[k] + 1; q < indptr[k + 1]; q++) {
        int64_t pj = work[indices[q]];
        if (pj >= 0) vals[pj] -= lik * vals[q];
      }
    }
    for (int64_t p = lo; p < hi; p++) work[indices[p]] = -1;
    if (vals[diag[i]] == 0.0) return -i - 1;
  }
  return 0;
}

// Dependency levels of a strictly-triangular CSR (trisolve level
// scheduling). lower != 0 -> forward order. Returns nlevels.
int64_t levels(int64_t n, const int64_t* indptr, const int64_t* indices,
               int64_t lower, int64_t* lev) {
  int64_t nlev = 0;
  if (lower) {
    for (int64_t i = 0; i < n; i++) {
      int64_t l = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; p++)
        l = std::max(l, lev[indices[p]] + 1);
      lev[i] = l;
      nlev = std::max(nlev, l + 1);
    }
  } else {
    for (int64_t i = n - 1; i >= 0; i--) {
      int64_t l = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; p++)
        l = std::max(l, lev[indices[p]] + 1);
      lev[i] = l;
      nlev = std::max(nlev, l + 1);
    }
  }
  return nlev < 1 ? 1 : nlev;
}

// ILU(k) symbolic factorization (aijfact.c:1536 MatILUFactorSymbolic
// role): level-of-fill pattern, k >= 0. Two-call protocol: call with
// out_indptr/out_indices = nullptr to get the required nnz; then call
// again with allocated buffers. Rows are emitted column-sorted.
int64_t iluk_symbolic(int64_t n, const int64_t* indptr,
                      const int64_t* indices, int64_t k,
                      int64_t* out_indptr, int64_t* out_indices) {
  // rowstruct[i] = sorted (col, level) pairs of factored row i
  std::vector<std::vector<std::pair<int64_t, int64_t>>> rows(n);
  std::vector<int64_t> lev(n, -1);   // col -> level for current row
  std::vector<int64_t> touched;
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    touched.clear();
    for (int64_t p = indptr[i]; p < indptr[i + 1]; p++) {
      int64_t c = indices[p];
      if (lev[c] < 0) touched.push_back(c);
      lev[c] = 0;
    }
    if (lev[i] < 0) { lev[i] = 0; touched.push_back(i); }  // force diag
    // eliminate with factored rows kk < i present in the pattern
    // (process kk in ascending order: collect, sort, sweep)
    std::vector<int64_t> pivots;
    for (int64_t c : touched)
      if (c < i) pivots.push_back(c);
    std::sort(pivots.begin(), pivots.end());
    for (size_t pi = 0; pi < pivots.size(); pi++) {
      int64_t kk = pivots[pi];
      int64_t lkk = lev[kk];
      if (lkk >= k + 1) continue;  // L entry beyond level limit: unused
      for (auto& ce : rows[kk]) {
        int64_t j = ce.first;
        if (j <= kk) continue;     // U-part of row kk only
        int64_t nl = lkk + ce.second + 1;
        if (nl > k) continue;
        if (lev[j] < 0) {
          lev[j] = nl;
          touched.push_back(j);
          if (j < i && j > kk) {
            // new pivot discovered; insert keeping order
            pivots.insert(std::upper_bound(pivots.begin() + pi + 1,
                                           pivots.end(), j), j);
          }
        } else if (nl < lev[j]) {
          lev[j] = nl;
        }
      }
    }
    std::sort(touched.begin(), touched.end());
    rows[i].reserve(touched.size());
    for (int64_t c : touched) rows[i].emplace_back(c, lev[c]);
    total += (int64_t)touched.size();
    for (int64_t c : touched) lev[c] = -1;
  }
  if (out_indptr) {
    int64_t pos = 0;
    out_indptr[0] = 0;
    for (int64_t i = 0; i < n; i++) {
      for (auto& ce : rows[i]) out_indices[pos++] = ce.first;
      out_indptr[i + 1] = pos;
    }
  }
  return total;
}

}  // extern "C"

// ===================================================================
// Exact serial HEM (hem.c MatCoarsenApply_HEM_private, the size==1
// specialization), -pc_gamg_mat_coarsen_type hem. Differences from the
// looser hem_aggregate of the reference's file (not copied): the edge
// list is stable-sorted descending with +-MY_MEPS-equal ties keeping
// row-major build order (glibc qsort on the reference side is a stable
// merge sort); matching sweeps gate each edge on BOTH endpoints'
// current max edge weight over unmatched neighbors (lid_max_ew logic,
// hem.c:699-717); boundary rows (max_e <= MY_MEPS at round 0,
// hem.c:586) pool into one fake aggregate; and each round contracts
// the graph tMat = P^T cMat P followed by a symmetric rescale to unit
// diagonal (hem.c:1088-1096).
// ===================================================================

static const double HEM_MEPS = 2.2204460492503131e-16 * 100.0;  // eps*100

extern "C" {

int64_t hem_match(int64_t n, const int64_t* indptr, const int64_t* indices,
                  const double* data, int64_t n_iter, double threshold,
                  int64_t* agg_out) {
  // working graph
  std::vector<int64_t> Ci(indptr, indptr + n + 1);
  std::vector<int64_t> Cj(indices, indices + indptr[n]);
  std::vector<double> Cx(data, data + indptr[n]);
  std::vector<std::vector<int64_t>> lists(n);
  for (int64_t i = 0; i < n; i++) lists[i] = {i};
  std::vector<int64_t> bc_pool;
  int64_t bc_agg = -1;

  struct Edge { int64_t i, j; double w; };
  std::vector<uint8_t> matched(n);
  std::vector<double> locmax(n);
  std::vector<int64_t> rootof(n);

  for (int64_t iter = 0; iter < n_iter; iter++) {
    for (int64_t k = 0; k < n; k++) matched[k] = lists[k].empty() ? 1 : 0;
    // initial locMax (threshold-filtered, hem.c:553-566) + BC detection
    for (int64_t i = 0; i < n; i++) {
      double max_e = 0.0;
      for (int64_t p = Ci[i]; p < Ci[i + 1]; p++) {
        int64_t j = Cj[p];
        double w = Cx[p];
        if (w > threshold && j != i && w > max_e) max_e = w;
      }
      locmax[i] = max_e;
      if (iter == 0 && max_e <= HEM_MEPS && !matched[i]) {
        matched[i] = 1;                      // BC fake aggregate
        if (bc_agg == -1) bc_agg = i;
        for (int64_t g : lists[i]) bc_pool.push_back(g);
        lists[i].clear();
      }
    }
    // edge list (i<j, w>threshold), row-major build order
    std::vector<Edge> edges;
    for (int64_t i = 0; i < n; i++)
      for (int64_t p = Ci[i]; p < Ci[i + 1]; p++) {
        int64_t j = Cj[p];
        double w = Cx[p];
        if (w > threshold && j > i) edges.push_back({i, j, w});
      }
    std::stable_sort(edges.begin(), edges.end(),
                     [](const Edge& a, const Edge& b) {
                       return a.w > b.w + HEM_MEPS;  // eps-equal: keep order
                     });
    for (int64_t i = 0; i < n; i++) rootof[i] = i;
    // matching sweeps (sub_it loop)
    int64_t old_active = -1;
    for (;;) {
      int64_t nactive = 0;
      for (const Edge& e : edges) {
        if (matched[e.i] || matched[e.j]) continue;
        nactive++;
        if (locmax[e.i] > e.w + HEM_MEPS) continue;
        if (locmax[e.j] > e.w + HEM_MEPS) continue;
        // match: j's list appends to i's (PetscCDMoveAppend)
        lists[e.i].insert(lists[e.i].end(), lists[e.j].begin(),
                          lists[e.j].end());
        lists[e.j].clear();
        matched[e.i] = matched[e.j] = 1;
        rootof[e.j] = e.i;
        nactive--;  // counted as active, then resolved
        nactive++;  // (reference counts it active; keep the count)
      }
      // recompute locMax over UNMATCHED neighbors (no threshold filter,
      // hem.c:987-1001)
      for (int64_t i = 0; i < n; i++) {
        double max_e = 0.0;
        for (int64_t p = Ci[i]; p < Ci[i + 1]; p++) {
          int64_t j = Cj[p];
          if (matched[j]) continue;
          if (j != i && Cx[p] > max_e) max_e = Cx[p];
        }
        locmax[i] = max_e;
      }
      if (nactive < 1) break;
      if (nactive == old_active) break;    // stall guard (reference errors)
      old_active = nactive;
    }
    if (iter == n_iter - 1) break;         // last round: skip contraction
    // contraction: (i,j,w) -> (map[i], map[j]) summed; drop vanished rows
    std::vector<int64_t> cmap(n);
    for (int64_t v = 0; v < n; v++) {
      if (!lists[v].empty()) cmap[v] = v;            // survivor
      else if (rootof[v] != v) cmap[v] = rootof[v];  // matched away now
      else cmap[v] = -1;                             // deleted earlier / BC
    }
    std::vector<int64_t> Ti(n + 2, 0);
    std::vector<double> acc(n, 0.0);
    std::vector<int64_t> mark(n, -1), cols;
    std::vector<int64_t> Nj;
    std::vector<double> Nx;
    Nj.reserve(Cj.size());
    Nx.reserve(Cx.size());
    std::vector<std::vector<int64_t>> rowsrc(n);
    for (int64_t i = 0; i < n; i++)
      if (cmap[i] >= 0) rowsrc[cmap[i]].push_back(i);
    std::vector<int64_t> Ni(n + 1, 0);
    for (int64_t r = 0; r < n; r++) {
      cols.clear();
      for (int64_t s : rowsrc[r]) {
        for (int64_t p = Ci[s]; p < Ci[s + 1]; p++) {
          int64_t jm = cmap[Cj[p]];
          if (jm < 0) continue;
          if (mark[jm] != r) { mark[jm] = r; acc[jm] = Cx[p];
                               cols.push_back(jm); }
          else acc[jm] += Cx[p];
        }
      }
      std::sort(cols.begin(), cols.end());
      for (int64_t j : cols) { Nj.push_back(j); Nx.push_back(acc[j]); }
      Ni[r + 1] = (int64_t)Nj.size();
    }
    Ci = Ni;
    Cj = Nj;
    Cx = Nx;
    // symmetric rescale to unit diagonal (hem.c:1092-1096)
    std::vector<double> dinv(n, 0.0);
    for (int64_t i = 0; i < n; i++)
      for (int64_t p = Ci[i]; p < Ci[i + 1]; p++)
        if (Cj[p] == i) {
          double d = std::fabs(Cx[p]);
          dinv[i] = d > 0 ? 1.0 / std::sqrt(d) : 0.0;
          break;
        }
    for (int64_t i = 0; i < n; i++)
      for (int64_t p = Ci[i]; p < Ci[i + 1]; p++)
        Cx[p] *= dinv[i] * dinv[Cj[p]];
  }
  // BC pool joins the first BC vertex's aggregate (hem.c:1131-1146)
  if (bc_agg >= 0)
    for (int64_t g : bc_pool) lists[bc_agg].push_back(g);
  int64_t nagg = 0;
  for (int64_t i = 0; i < n; i++) agg_out[i] = -1;
  for (int64_t i = 0; i < n; i++) {
    if (lists[i].empty()) continue;
    for (int64_t g : lists[i]) agg_out[g] = nagg;
    nagg++;
  }
  return nagg;
}

// The ordering, colouring and loose heavy-edge-matching kernels of
// petsc_tpu/native/graphops.cpp:126-252, verbatim: MatGetOrdering's rcm,
// MatFDColoring's greedy colouring and hem_aggregate.
// Reverse Cuthill-McKee ordering (genrcm.c role): BFS from a
// pseudo-peripheral vertex of each component, neighbors by increasing
// degree, then reverse. perm[newidx] = oldidx.
// The reference's loop skips a `start` whose BFS root lies in another
// component, so it can leave vertices unvisited (and then read past the
// end of `order`); a second pass starts a BFS from each vertex still
// unvisited, which changes nothing where the first pass visits them all.
void rcm(int64_t n, const int64_t* indptr, const int64_t* indices,
         int64_t* perm) {
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; i++) deg[i] = indptr[i + 1] - indptr[i];
  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> nbrs;
  auto bfs = [&](int64_t root) {
    std::queue<int64_t> q;
    q.push(root);
    visited[root] = 1;
    while (!q.empty()) {
      int64_t v = q.front(); q.pop();
      order.push_back(v);
      nbrs.clear();
      for (int64_t p = indptr[v]; p < indptr[v + 1]; p++) {
        int64_t j = indices[p];
        if (!visited[j]) { visited[j] = 1; nbrs.push_back(j); }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
      for (int64_t j : nbrs) q.push(j);
    }
  };
  for (int64_t start = 0; start < n; start++) {
    if (visited[start]) continue;
    // pseudo-peripheral: min-degree unvisited in this sweep start
    int64_t root = start;
    for (int64_t i = start; i < n; i++)
      if (!visited[i] && deg[i] < deg[root]) root = i;
    // (cheap variant of the GPS root finder)
    bfs(root);
  }
  for (int64_t v = 0; v < n; v++)
    if (!visited[v]) bfs(v);
  for (int64_t i = 0; i < n; i++) perm[i] = order[n - 1 - i];
}

// Greedy distance-1 coloring of an adjacency CSR (columns of a conflict
// graph; impls/color/greedy role). Returns number of colors.
int64_t greedy_color(int64_t n, const int64_t* indptr,
                     const int64_t* indices, int64_t* colors) {
  for (int64_t i = 0; i < n; i++) colors[i] = -1;
  std::vector<int64_t> mark(n + 1, -1);
  int64_t ncolor = 0;
  for (int64_t v = 0; v < n; v++) {
    for (int64_t p = indptr[v]; p < indptr[v + 1]; p++) {
      int64_t c = colors[indices[p]];
      if (c >= 0) mark[c] = v;
    }
    int64_t c = 0;
    while (mark[c] == v) c++;
    colors[v] = c;
    if (c + 1 > ncolor) ncolor = c + 1;
  }
  return ncolor;
}

// Heavy-edge matching coarsening (mat/graphops/coarsen/impls/hem role):
// greedily match each vertex with its heaviest unmatched neighbor,
// repeated `rounds` times on the contracted graph. Returns nagg; agg[i]
// receives the final aggregate id of vertex i.
int64_t hem_aggregate(int64_t n, const int64_t* indptr,
                      const int64_t* indices, const double* weights,
                      int64_t rounds, int64_t* agg) {
  std::vector<int64_t> label(n);
  for (int64_t i = 0; i < n; i++) label[i] = i;
  // edge list view is re-derived per round through the labels
  for (int64_t r = 0; r < rounds; r++) {
    // order vertices by heaviest incident edge (desc) for greedy matching
    std::vector<int64_t> reps;
    reps.reserve(n);
    std::vector<uint8_t> matched(n, 0);
    std::vector<double> best(n, -1.0);
    for (int64_t i = 0; i < n; i++)
      if (label[i] == label[label[i]])  ;  // no-op, labels are flat
    // flatten labels
    for (int64_t i = 0; i < n; i++) {
      int64_t l = label[i];
      while (l != label[l]) l = label[l];
      label[i] = l;
    }
    // accumulate inter-aggregate weights on the fly: for each vertex pick
    // the heaviest edge to a different aggregate
    std::vector<int64_t> heavy_to(n, -1);
    std::vector<double> heavy_w(n, 0.0);
    for (int64_t i = 0; i < n; i++) {
      int64_t li = label[i];
      for (int64_t p = indptr[i]; p < indptr[i + 1]; p++) {
        int64_t j = indices[p];
        int64_t lj = label[j];
        if (lj == li) continue;
        double w = weights ? std::abs(weights[p]) : 1.0;
        if (w > heavy_w[li]) { heavy_w[li] = w; heavy_to[li] = lj; }
      }
    }
    // greedy symmetric-ish matching over aggregate representatives
    std::vector<int64_t> order;
    for (int64_t i = 0; i < n; i++)
      if (label[i] == i) order.push_back(i);
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return heavy_w[a] > heavy_w[b];
    });
    for (int64_t a : order) {
      if (matched[a] || heavy_to[a] < 0) continue;
      int64_t b = heavy_to[a];
      if (matched[b]) continue;
      matched[a] = matched[b] = 1;
      label[b] = a;
    }
  }
  // final flatten + compact ids
  std::vector<int64_t> id(n, -1);
  int64_t nagg = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t l = label[i];
    while (l != label[l]) l = label[l];
    label[i] = l;
  }
  for (int64_t i = 0; i < n; i++)
    if (label[i] == i) id[i] = nagg++;
  for (int64_t i = 0; i < n; i++) agg[i] = id[label[i]];
  return nagg;
}

}  // extern "C"
