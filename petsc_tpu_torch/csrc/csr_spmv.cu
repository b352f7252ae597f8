// S2: the general CSR SpMV  y[i] = sum_{k in [indptr[i], indptr[i+1])} vals[k] * x[col[k]],
// f64 and f32.
//
// Replaces petsc_tpu/mat/aij.py:1554-1561 (_bind_aij_csr mult), which the
// TPU ran as XLA's gather plus segment_sum (petsc_tpu/ops/spmv.py:45-47
// csr_seg_spmv). The TPU has no hardware gather; Hopper has one, so the
// product is one pass over the CSR arrays.
//
// Bound: the bytes, nnz * (itemsize + 4) for vals and col, plus indptr,
// x read once and y written once, for 2 nnz flops: device-memory
// bandwidth (x is read again for every entry that names it; those reads
// mostly hit L2 for a banded pattern).
// Design: one sub-warp of W lanes per row (W = 4, 8, 16 or 32, chosen by
// the wrapper from the mean row length). The lanes stride the row, so a
// row's vals and col are read coalesced; x is read through the read-only
// path. Each lane sums its entries in order and the sub-warp is reduced
// with shuffles in a fixed tree: no atomics, so a rerun gives the same
// bits. indptr is int64 (rows of any length); col is int32, so the
// wrapper takes at most 2^31 - 1 columns. The trip count of the row loop
// is uniform across a warp, so every lane reaches the full-warp shuffles.
#include "common.cuh"

template <typename T, int W>
__global__ void __launch_bounds__(ptt::kThreads)
csr_spmv_kernel(T* __restrict__ y, const long long* __restrict__ indptr,
                const int* __restrict__ col, const T* __restrict__ vals,
                const T* __restrict__ x, long long m) {
  constexpr int kGroupsPerWarp = 32 / W;
  const int lane = threadIdx.x & (W - 1);
  const int group_in_warp = (threadIdx.x & 31) / W;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * kGroupsPerWarp; base < m; base += nwarps * kGroupsPerWarp) {
    const long long row = base + group_in_warp;
    T s = T(0);
    if (row < m) {
      const long long hi = indptr[row + 1];
      for (long long k = indptr[row] + lane; k < hi; k += W) s += vals[k] * __ldg(x + col[k]);
    }
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off, W);
    if (row < m && lane == 0) y[row] = s;
  }
}

template <typename T, int W>
static void launch_w(T* y, const long long* indptr, const int* col, const T* vals, const T* x,
                     long long m, int device, cudaStream_t stream) {
  const int grid = ptt::grid_for(m * W, device, 1LL << 30);
  csr_spmv_kernel<T, W><<<grid, ptt::kThreads, 0, stream>>>(y, indptr, col, vals, x, m);
}

template <typename T>
static int launch_csr(void* y, const void* indptr, const void* col, const void* vals,
                      const void* x, long long m, int width, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  auto* yy = (T*)y;
  auto* ip = (const long long*)indptr;
  auto* cc = (const int*)col;
  auto* vv = (const T*)vals;
  auto* xx = (const T*)x;
  auto st = (cudaStream_t)stream;
  switch (width) {
    case 4: launch_w<T, 4>(yy, ip, cc, vv, xx, m, device, st); break;
    case 8: launch_w<T, 8>(yy, ip, cc, vv, xx, m, device, st); break;
    case 16: launch_w<T, 16>(yy, ip, cc, vv, xx, m, device, st); break;
    case 32: launch_w<T, 32>(yy, ip, cc, vv, xx, m, device, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ptt_csr_spmv_f64(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, int width, int device, void* stream) {
  return launch_csr<double>(y, indptr, col, vals, x, m, width, device, stream);
}

extern "C" int ptt_csr_spmv_f32(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, int width, int device, void* stream) {
  return launch_csr<float>(y, indptr, col, vals, x, m, width, device, stream);
}
