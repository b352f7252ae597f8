// The thread-per-destination design of X1, the deterministic scatter by
// destination (petsc_tpu/pc/bddc.py:138 and the other scatter-adds and
// scatter-sets of the domain-decomposition PCs), as
// petsc_tpu_torch/csrc/dst_scatter.cu had it before the batched short runs
// and the warps on long runs replaced it. It is not part of the package's
// kernel library: chip_smoke.py builds it on its own only to time the two
// designs in turns on one card, on the same inputs.
// The kernel is the earlier one unchanged; only the entry points are
// renamed (ptt_earlier_dst_scatter_*) and PTT_TRY, kThreads and grid_for
// are defined here. It takes the same table (ptr, sel, w) without the
// table's list of long destinations.
//
// X1: the deterministic scatter by destination, f64 and f32.
//
//   y[d] = sum over k with dst_k = d of w_k * src[sel_k], summed in k order
//
// Replaces the scatter-adds and scatter-sets that the JAX package leaves to
// XLA's `.at[].add` / `.at[].set` (atomics on a GPU, so no fixed order):
// MatIS's apply (petsc_tpu_torch/mat/utility.py, the reference's
// mat/utility.py), ASM's owned-row and overlap scatters
// (petsc_tpu/pc/more_pc.py:323-327), PCPatch and PCGASM
// (petsc_tpu/pc/extras_pc.py:859-870), PCNN (petsc_tpu/pc/r3_pc.py:241-249),
// BDDC's coarse scatter and final add (petsc_tpu/pc/bddc.py:129-138),
// fieldsplit's scatter-set (petsc_tpu/pc/more_pc.py:595-596) and fetidp's
// jump operator B and its transpose (petsc_tpu/ksp/fetidp.py:114-131).
//
// Tables, built once at set-up (ops/pc_kernels.py scatter_table): the
// entries sorted by destination, stably, as CSR row pointers ptr (n + 1),
// the source index sel and the optional weight w of each entry. Each thread
// owns destinations (a grid-stride loop) and sums its own entries from 0 in
// their order, so no two threads write one word, no atomics are used and
// the bits do not depend on the grid. Products and sums are rounded one by
// one (__dmul_rn, __dadd_rn: no contraction to an FMA), so the result
// equals the plain version's bit for bit. Modes: add (every destination
// written, 0 where no entry lands), set (a destination with no entry keeps
// its value: skip_empty), signed (add with w = +-1, or +-scale).
//
// Bound: device-memory bandwidth: ptr, sel and w read once, y written once
// and the 32-byte sectors of src that sel touches read once; one multiply
// (weighted) and one add per entry.
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

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
dst_scatter_kernel(T* __restrict__ y, const T* __restrict__ src, const int* __restrict__ ptr,
                   const int* __restrict__ sel, const T* __restrict__ w, long long n,
                   int skip_empty) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x; d < n; d += stride) {
    const int s = __ldg(ptr + d), e = __ldg(ptr + d + 1);
    if (skip_empty && s == e) continue;
    T acc = T(0);
    if (w) {
      for (int k = s; k < e; ++k) acc = add_rn(acc, mul_rn(__ldg(w + k), __ldg(src + __ldg(sel + k))));
    } else {
      for (int k = s; k < e; ++k) acc = add_rn(acc, __ldg(src + __ldg(sel + k)));
    }
    y[d] = acc;
  }
}

template <typename T>
int launch(void* y, const void* src, const void* ptr, const void* sel, const void* w,
           long long n, int skip_empty, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  dst_scatter_kernel<T><<<ptt::grid_for(n, device, 1LL << 30), ptt::kThreads, 0,
                          (cudaStream_t)stream>>>((T*)y, (const T*)src, (const int*)ptr,
                                                  (const int*)sel, (const T*)w, n, skip_empty);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_earlier_dst_scatter_f64(void* y, const void* src, const void* ptr, const void* sel,
                                   const void* w, long long n, int skip_empty, int device,
                                   void* stream) {
  return launch<double>(y, src, ptr, sel, w, n, skip_empty, device, stream);
}

extern "C" int ptt_earlier_dst_scatter_f32(void* y, const void* src, const void* ptr, const void* sel,
                                   const void* w, long long n, int skip_empty, int device,
                                   void* stream) {
  return launch<float>(y, src, ptr, sel, w, n, skip_empty, device, stream);
}
