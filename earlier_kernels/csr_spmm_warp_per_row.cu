// The warp-per-row design of M1, the CSR times row-major block product
// Y = A X (petsc_tpu/mat/utility.py:356-372, MatMAIJ's vmapped CSR
// product), as petsc_tpu_torch/csrc/csr_spmm.cu had it before the entry
// tiles replaced it. It is not part of the package's kernel library:
// chip_smoke.py and m1_probe.py build it on their own (one nvcc into
// petsc_tpu_torch/_build/earlier-<hash>/, or a scratch directory) only to
// time the two designs in turns on one card, on the same inputs. The
// kernel is the earlier one unchanged; only the entry points are renamed
// (ptt_earlier_csr_spmm_*) and PTT_TRY, kThreads, fma_rn and grid_for are
// defined here.
//
// M1: CSR times a row-major block of vectors,
//   Y[i, c] = sum_{p in [indptr[i], indptr[i+1])} vals[p] * X[col[p], c],
// f64 and f32, for X of shape (n, ld) row-major and a tile of kt <= 8 of
// its columns per launch.
//
// Replaces no Pallas kernel: the reference applies a sparse operator to
// every component of a node-major block as one jax.vmap of the CSR product
// (petsc_tpu/mat/utility.py:356-372, MatMAIJ) or as a stack of p products
// (petsc_tpu/mat/extra_formats.py:59-70, MatKAIJ); ops/spmv.py:40 ell_spmm
// has the same semantics. Run as k launches of S2 that would read the
// matrix k times; here it is read once for all k columns.
//
// Bound: nnz * (itemsize + 4) + (m + 1) * 8 + (n + m) * k * itemsize bytes
// (vals and col streamed once, indptr read once, X read once, Y written
// once) over 3.35 TB/s, for 2 nnz k flops: device-memory bandwidth. On the
// 128^3 box27 CSR at k = 3 in f64 that is 0.235 ms.
//
// Design (simple first): one warp per row, lanes over the row's entries
// (lane j takes entries j, j + 32, ...), kt accumulators per lane, the kt
// values of X[col, :] read together (one row of X is kt adjacent values),
// a fixed xor-shuffle reduction per column, and lanes 0..kt-1 store the
// row's kt results to adjacent addresses. The multiply-adds are written
// out (fma), so the bits do not depend on the compiler's contractions, and
// every run sums in the same order. Rows are taken grid-stride by a grid of
// eight 256-thread blocks per SM. indptr is int64 (rows of any length);
// col is int32, so X holds fewer than 2^31 rows.
#include <cuda_runtime.h>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace ptt {

constexpr int kThreads = 256;

__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// Blocks for a grid-stride loop over `work` items: 8 blocks of kThreads
// per SM at most, never more than the work needs or than `cap`.
inline int grid_for(long long work, int device, long long cap) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms < 1)
    sms = 132;
  long long g = (work + kThreads - 1) / kThreads;
  const long long fill = (long long)sms * 8;
  if (g > fill) g = fill;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

}  // namespace ptt

namespace {

constexpr int kWarp = 32;
constexpr int kMaxTile = 8;       // columns per launch; the wrapper tiles a wider X

template <typename T, int K>
__global__ void __launch_bounds__(ptt::kThreads)
csr_spmm_kernel(T* __restrict__ y, const long long* __restrict__ indptr, const int* __restrict__ col,
                const T* __restrict__ vals, const T* __restrict__ x, long long m, int ld) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warps_per_block = blockDim.x / kWarp;
  const long long stride = (long long)gridDim.x * warps_per_block;
  for (long long row = (long long)blockIdx.x * warps_per_block + threadIdx.x / kWarp; row < m;
       row += stride) {
    const long long lo = indptr[row], hi = indptr[row + 1];
    T acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = T(0);
    for (long long p = lo + lane; p < hi; p += kWarp) {
      const T a = __ldg(vals + p);
      const T* xr = x + (long long)__ldg(col + p) * ld;
      T xv[K];
#pragma unroll
      for (int c = 0; c < K; ++c) xv[c] = __ldg(xr + c);
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = ptt::fma_rn(a, xv[c], acc[c]);
    }
    // the row index is the same for the whole warp, so every lane is here
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
    if (lane < K) {
      T out = acc[0];
#pragma unroll
      for (int c = 1; c < K; ++c)
        if (lane == c) out = acc[c];
      y[row * ld + lane] = out;
    }
  }
}

template <typename T, int K>
static int launch_tile(T* y, const long long* indptr, const int* col, const T* vals, const T* x,
                       long long m, int ld, int device, cudaStream_t stream) {
  const int grid = ptt::grid_for(m * kWarp, device, 1LL << 30);
  csr_spmm_kernel<T, K><<<grid, ptt::kThreads, 0, stream>>>(y, indptr, col, vals, x, m, ld);
  return (int)cudaGetLastError();
}

// y, x: the tile's first column (the caller adds the column offset); ld:
// the full row length of X and Y; kt: the tile's columns, 1..8.
template <typename T>
static int launch_csr_spmm(void* y, const void* indptr, const void* col, const void* vals,
                           const void* x, long long m, int ld, int kt, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  T* yo = (T*)y;
  const long long* ip = (const long long*)indptr;
  const int* cl = (const int*)col;
  const T* v = (const T*)vals;
  const T* xi = (const T*)x;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kt) {
    case 1: return launch_tile<T, 1>(yo, ip, cl, v, xi, m, ld, device, s);
    case 2: return launch_tile<T, 2>(yo, ip, cl, v, xi, m, ld, device, s);
    case 3: return launch_tile<T, 3>(yo, ip, cl, v, xi, m, ld, device, s);
    case 4: return launch_tile<T, 4>(yo, ip, cl, v, xi, m, ld, device, s);
    case 5: return launch_tile<T, 5>(yo, ip, cl, v, xi, m, ld, device, s);
    case 6: return launch_tile<T, 6>(yo, ip, cl, v, xi, m, ld, device, s);
    case 7: return launch_tile<T, 7>(yo, ip, cl, v, xi, m, ld, device, s);
    case 8: return launch_tile<T, kMaxTile>(yo, ip, cl, v, xi, m, ld, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ptt_earlier_csr_spmm_f64(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, int ld, int kt, int device,
                                void* stream) {
  return launch_csr_spmm<double>(y, indptr, col, vals, x, m, ld, kt, device, stream);
}

extern "C" int ptt_earlier_csr_spmm_f32(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, int ld, int kt, int device,
                                void* stream) {
  return launch_csr_spmm<float>(y, indptr, col, vals, x, m, ld, kt, device, stream);
}
