// The warp-per-row design of D1, the batched dense subdomain apply
// (petsc_tpu/pc/bddc.py:127, :131, :136 and the MatIS local products), as
// petsc_tpu_torch/csrc/subdomain.cu had it before the row runs of a
// one-wave grid replaced it. It is not part of the package's kernel
// library: chip_smoke.py builds it on its own (one nvcc into
// petsc_tpu_torch/_build/earlier-<hash>/) only to time the two designs in
// turns on one card, on the same inputs.
// The kernels are the earlier ones unchanged; only the entry points are
// renamed (ptt_earlier_subdomain_apply_*) and PTT_TRY is defined here.
//
// D1: the batched dense subdomain apply, f64 and f32.
//
//   plain form       Y[s, i] = sum_j M[s, i, j] * t[s, j]     (M is ns x R x C)
//   transposed form  Y[s, i] = sum_j M[s, j, i] * t[s, j]
//   with             t[s, j] = w[s, j] * x[G[s, j]]           (w optional)
//
// Replaces the padded batched products that the JAX package leaves to XLA's
// einsum on the TPU: MatIS's apply (the local products, petsc_tpu's
// mat/utility.py), PCNN's local pseudo-inverse solves
// (petsc_tpu/pc/r3_pc.py:241-242), BDDC's dual solve on K_qq^-1 and its
// coarse restriction and interpolation Phi^T and Phi
// (petsc_tpu/pc/bddc.py:127-136) and, through BDDC's tables, fetidp's
// Ktilde^-1 and its lumped preconditioner (petsc_tpu/ksp/fetidp.py:80-98,
// :120-128). The tables are padded as the reference lays them out; the
// optional per-subdomain counts nr[s] (rows) and nc[s] (columns) say how
// much of each is real, and padding is neither read nor summed. The output
// goes to a local buffer (ns x ldy): row i of subdomain s to slot out[s, i]
// when an output map is given (BDDC's Qidx: -1 skips the slot), else to
// slot i; with `accumulate` it is added to what the slot holds (BDDC's
// zl = Phi xc + dual part), else it replaces it, and padded rows get 0.
//
// Bound: device-memory bandwidth: the real part of M read once (2.43 GB
// in f64 for 256 subdomains of 1,089 dofs), the gathered x, G and w, and
// Y written once; 2 flops per entry of M.
// Design for that bound: plain form, a block of 8 warps per (subdomain,
// 64 rows); the block first forms t[s, :] in shared memory (one gather
// per entry per block), then each warp takes a row at a time, its lanes
// along the row (one 256-byte load per warp and step, two sums in flight),
// and reduces with shuffles. Transposed form, a block of 32 x 8 threads per
// (subdomain, 32 columns): lane x owns a column, the 8 rows of threads
// split the rows, and the 8 partial sums meet in shared memory.
#include <cuda_runtime.h>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace {

constexpr int kRowsPerBlock = 64;
constexpr int kColsPerBlock = 32;
constexpr int kRowSplit = 8;

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ y, long long s, int ldy, const int* out,
                                      int nrow, int i, T v, int accumulate) {
  int o = i;
  if (out) {
    o = __ldg(out + s * nrow + i);
    if (o < 0) return;
  }
  T* p = y + s * ldy + o;
  *p = accumulate ? *p + v : v;
}

template <typename T>
__global__ void __launch_bounds__(256)
subdomain_kernel(T* __restrict__ y, const T* __restrict__ M, const T* __restrict__ x,
                 const int* __restrict__ G, const T* __restrict__ w, const int* __restrict__ out,
                 const int* __restrict__ nr, const int* __restrict__ nc, int nrow, int ncol,
                 int ldy, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);
  const long long s = blockIdx.y;
  const int rows = nr ? __ldg(nr + s) : nrow;
  const int cols = nc ? __ldg(nc + s) : ncol;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, nrow);
  if (r0 < rows) {
    for (int j = threadIdx.x; j < cols; j += blockDim.x) {
      const long long g = s * ncol + j;
      const T v = __ldg(x + __ldg(G + g));
      t[j] = w ? __ldg(w + g) * v : v;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int i = r0 + warp; i < r1; i += nwarps) {
    T sum = T(0);
    if (i < rows) {
      const T* row = M + (s * nrow + i) * (long long)ncol;
      T a0 = T(0), a1 = T(0);
      int j = lane;
      for (; j + 32 < cols; j += 64) {
        a0 += __ldg(row + j) * t[j];
        a1 += __ldg(row + j + 32) * t[j + 32];
      }
      if (j < cols) a0 += __ldg(row + j) * t[j];
      sum = a0 + a1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    } else if (out || accumulate) {
      continue;
    }
    if (lane == 0) store(y, s, ldy, out, nrow, i, sum, accumulate);
  }
}

template <typename T>
__global__ void __launch_bounds__(kColsPerBlock * kRowSplit)
subdomain_t_kernel(T* __restrict__ y, const T* __restrict__ M, const T* __restrict__ x,
                   const int* __restrict__ G, const T* __restrict__ w, const int* __restrict__ out,
                   const int* __restrict__ nr, const int* __restrict__ nc, int nrow, int ncol,
                   int ldy, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);
  __shared__ T part[kRowSplit][kColsPerBlock];
  const long long s = blockIdx.y;
  const int rows = nr ? __ldg(nr + s) : nrow;
  const int cols = nc ? __ldg(nc + s) : ncol;
  const int tid = threadIdx.y * kColsPerBlock + threadIdx.x;
  for (int j = tid; j < rows; j += kColsPerBlock * kRowSplit) {
    const long long g = s * nrow + j;
    const T v = __ldg(x + __ldg(G + g));
    t[j] = w ? __ldg(w + g) * v : v;
  }
  __syncthreads();
  const int i = blockIdx.x * kColsPerBlock + threadIdx.x;
  T acc = T(0);
  if (i < cols) {
    const T* base = M + s * nrow * (long long)ncol + i;
    for (int j = threadIdx.y; j < rows; j += kRowSplit) acc += __ldg(base + (long long)j * ncol) * t[j];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < ncol) {
    T sum = T(0);
#pragma unroll
    for (int r = 0; r < kRowSplit; ++r) sum += part[r][threadIdx.x];
    if (i < cols || !(out || accumulate)) store(y, s, ldy, out, ncol, i, sum, accumulate);
  }
}

template <typename T>
int launch(int transposed, void* y, const void* M, const void* x, const void* G, const void* w,
           const void* out, const void* nr, const void* nc, int ns, int nrow, int ncol, int ldy,
           int accumulate, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  const size_t smem = (size_t)(transposed ? nrow : ncol) * sizeof(T);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (transposed) {
    auto k = subdomain_t_kernel<T>;
    if (smem > 48 * 1024)
      PTT_TRY(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    dim3 grid((ncol + kColsPerBlock - 1) / kColsPerBlock, ns);
    k<<<grid, dim3(kColsPerBlock, kRowSplit), smem, (cudaStream_t)stream>>>(
        (T*)y, (const T*)M, (const T*)x, (const int*)G, (const T*)w, (const int*)out,
        (const int*)nr, (const int*)nc, nrow, ncol, ldy, accumulate);
  } else {
    auto k = subdomain_kernel<T>;
    if (smem > 48 * 1024)
      PTT_TRY(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    dim3 grid((nrow + kRowsPerBlock - 1) / kRowsPerBlock, ns);
    k<<<grid, 256, smem, (cudaStream_t)stream>>>(
        (T*)y, (const T*)M, (const T*)x, (const int*)G, (const T*)w, (const int*)out,
        (const int*)nr, (const int*)nc, nrow, ncol, ldy, accumulate);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_earlier_subdomain_apply_f64(int transposed, void* y, const void* M, const void* x,
                                       const void* G, const void* w, const void* out,
                                       const void* nr, const void* nc, int ns, int nrow,
                                       int ncol, int ldy, int accumulate, int device,
                                       void* stream) {
  return launch<double>(transposed, y, M, x, G, w, out, nr, nc, ns, nrow, ncol, ldy, accumulate,
                        device, stream);
}

extern "C" int ptt_earlier_subdomain_apply_f32(int transposed, void* y, const void* M, const void* x,
                                       const void* G, const void* w, const void* out,
                                       const void* nr, const void* nc, int ns, int nrow,
                                       int ncol, int ldy, int accumulate, int device,
                                       void* stream) {
  return launch<float>(transposed, y, M, x, G, w, out, nr, nc, ns, nrow, ncol, ldy, accumulate,
                       device, stream);
}
