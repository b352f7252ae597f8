// The per-output design of B1, the block-CSR product y = A x
// (petsc_tpu/mat/aij.py:1494-1504 _bind_aij_bell.mult), as
// petsc_tpu_torch/csrc/bsr_spmv.cu had it before the chunk ring replaced
// it. It is not part of the package's kernel library: chip_smoke.py builds
// it on its own (one nvcc into petsc_tpu_torch/_build/earlier-<hash>/)
// only to time the two designs in turns on one card, on the same inputs.
// The kernel is the earlier one unchanged; only the entry points are
// renamed (ptt_earlier_bsr_spmv_*) and PTT_TRY, kThreads and grid_for
// are defined here.
//
// B1: the block-CSR (BSR) product y = A x, f64 and f32.
//
// Replaces the block-ELL product of petsc_tpu/mat/aij.py:1494-1504
// (_bind_aij_bell.mult: gather x by block column, then a batched bs x bs
// einsum, left to XLA on the TPU). The port stores the blocks as BSR: int64
// block-row pointers (mb + 1), int32 block columns, values (nblocks, bs, bs)
// row-major; the reference's padding to Kb blocks per row is ELL for the
// TPU's fixed shapes, not semantics. For block row i and component r,
//   y[i bs + r] = sum over the row's blocks k (in order) of
//                 sum over c (in order) of V[k, r, c] x[col[k] bs + c],
// each block's inner sum formed first, then added to the row's running sum
// which starts at 0. The arithmetic is rounded step by step (__dmul_rn,
// __dadd_rn: no fused multiply-add), so the plain PyTorch version, which
// takes the same steps as separate tensor operations, gives equal bits.
//
// Bound: device-memory bandwidth. Each value is read once (bs^2 per block),
// each block column once, the pointers once, x and y once: at ex56 ne 64
// (823,875 rows, 7,189,057 blocks of 3 x 3) in f64, 517.6 MB of values,
// 28.8 MB of columns, 2.2 MB of pointers and 13.2 MB of x and y, 0.168 ms at
// 3.35 TB/s, about 2 flops per 8-byte value.
// Design for that bound (a first, simple kernel): one thread per output
// (block row, component), a grid-stride loop, so the bs threads of a block
// row walk its blocks together: their value reads (bs contiguous entries
// each, bs^2 together) cover each block's bytes once and the next block
// follows in the same cache lines; the block column and x's bs entries are
// read by all bs threads from the same sectors. bs is a template argument
// for 2, 3, 4 and 6 (the inner sum unrolled) and a run-time loop for any
// other size up to 8.
#include <cuda_runtime.h>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace ptt {

constexpr int kThreads = 256;

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

constexpr int kMaxBs = 8;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// BS > 0: the block size at compile time; BS == 0: bs at run time.
template <int BS, typename T>
__global__ void __launch_bounds__(ptt::kThreads)
bsr_spmv_kernel(T* __restrict__ y, const long long* __restrict__ indptr,
                const int* __restrict__ bcol, const T* __restrict__ vals,
                const T* __restrict__ x, long long mb, int bs_rt) {
  const int bs = BS > 0 ? BS : bs_rt;
  const long long n = mb * bs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const long long i = t / bs;
    const int r = (int)(t - i * bs);
    const long long k0 = __ldg(indptr + i), k1 = __ldg(indptr + i + 1);
    T acc = T(0);
#pragma unroll 4
    for (long long k = k0; k < k1; ++k) {
      const T* v = vals + (k * bs + r) * bs;
      const T* xb = x + (long long)__ldg(bcol + k) * bs;
      T s = mul_rn(__ldg(v), __ldg(xb));
      if constexpr (BS > 0) {
#pragma unroll
        for (int c = 1; c < BS; ++c) s = add_rn(s, mul_rn(__ldg(v + c), __ldg(xb + c)));
      } else {
        for (int c = 1; c < bs; ++c) s = add_rn(s, mul_rn(__ldg(v + c), __ldg(xb + c)));
      }
      acc = add_rn(acc, s);
    }
    y[t] = acc;
  }
}

template <int BS, typename T>
int launch_bs(T* y, const long long* indptr, const int* bcol, const T* vals, const T* x,
              long long mb, int bs, int device, cudaStream_t stream) {
  const long long n = mb * bs;
  bsr_spmv_kernel<BS, T><<<ptt::grid_for(n, device, 1LL << 30), ptt::kThreads, 0, stream>>>(
      y, indptr, bcol, vals, x, mb, bs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bsr(void* y, const void* indptr, const void* bcol, const void* vals, const void* x,
               long long mb, int bs, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  if (bs < 1 || bs > kMaxBs) return (int)cudaErrorInvalidValue;
  if (mb == 0) return (int)cudaSuccess;
  auto* yy = (T*)y;
  auto* ip = (const long long*)indptr;
  auto* bc = (const int*)bcol;
  auto* vv = (const T*)vals;
  auto* xx = (const T*)x;
  auto s = (cudaStream_t)stream;
  switch (bs) {
    case 2: return launch_bs<2, T>(yy, ip, bc, vv, xx, mb, bs, device, s);
    case 3: return launch_bs<3, T>(yy, ip, bc, vv, xx, mb, bs, device, s);
    case 4: return launch_bs<4, T>(yy, ip, bc, vv, xx, mb, bs, device, s);
    case 6: return launch_bs<6, T>(yy, ip, bc, vv, xx, mb, bs, device, s);
    default: return launch_bs<0, T>(yy, ip, bc, vv, xx, mb, bs, device, s);
  }
}

}  // namespace

extern "C" int ptt_earlier_bsr_spmv_f64(void* y, const void* indptr, const void* bcol, const void* vals,
                                const void* x, long long mb, int bs, int device, void* stream) {
  return launch_bsr<double>(y, indptr, bcol, vals, x, mb, bs, device, stream);
}

extern "C" int ptt_earlier_bsr_spmv_f32(void* y, const void* indptr, const void* bcol, const void* vals,
                                const void* x, long long mb, int bs, int device, void* stream) {
  return launch_bsr<float>(y, indptr, bcol, vals, x, mb, bs, device, stream);
}
