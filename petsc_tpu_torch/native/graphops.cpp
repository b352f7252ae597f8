// Native host kernels of the Galerkin setup for petsc_tpu_torch.
//
// The port's own copy of the SpGEMM, CSR transpose and CSR matvec of
// petsc_tpu/native/graphops.cpp (the reference's host "symbolic and
// numeric phase" of PCSetUp_GAMG / PCSetUp_MG: the scalable PtAP of
// mpiptap.c:215 as a Gustavson count+fill SpGEMM, the transpose that
// forms R = P^T, and the row-parallel matvec of the host Arnoldi
// eigenvalue estimate). The aggregation, ordering and factorization
// kernels of the reference's file arrive with the slices that call them.
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
#include <vector>
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

void csr_matvec(int64_t n, const int64_t* Ai, const int64_t* Aj,
                const double* Ax, const double* x, double* y) {
  csr_matvec_t<int64_t>(n, Ai, Aj, Ax, x, y);
}
void csr_matvec_i32(int32_t n, const int32_t* Ai, const int32_t* Aj,
                    const double* Ax, const double* x, double* y) {
  csr_matvec_t<int32_t>(n, Ai, Aj, Ax, x, y);
}

}  // extern "C"
