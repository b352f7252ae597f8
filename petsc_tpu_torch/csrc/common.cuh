// Helpers shared by the hand-written Hopper kernels of petsc_tpu_torch.
//
// Every kernel is built for sm_90a with a plain C entry point that the
// Python wrappers in petsc_tpu_torch/ops/pallas_kernels.py load with
// ctypes. An entry point sets the device, launches on the stream it is
// given, never synchronises, and returns cudaGetLastError() so that a
// refused launch is reported to the wrapper, which raises.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace ptt {

constexpr int kThreads = 256;      // threads per block of the streaming kernels
constexpr int kBlocksPerSM = 8;    // 8 x 256 threads fill an SM's 2048 thread slots
constexpr int kFinishThreads = 1024;
constexpr int kMaxDevices = 64;    // devices whose launch shape is cached

// 16 bytes of T: one 128-bit load or store per thread, neighbouring threads
// on neighbouring addresses (2 doubles or 4 floats).
template <typename T>
struct alignas(16) Pack {
  static constexpr int kWidth = 16 / sizeof(T);
  T v[kWidth];
};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// C1's z modes on one element: p = c z (kFirst) or p = a p + c z, then
// x += beta p. The standalone z kernel (cheby.cu) and A1's epilogue
// (agg_block.cu) both call it; the fused multiply-adds are written out, so
// no contraction the compiler picks can make the two give other bits.
template <bool kFirst, typename T>
__device__ __forceinline__ void cheby_z_update(T& p, T& x, T z, T a, T c, T beta) {
  p = kFirst ? c * z : fma_rn(a, p, c * z);
  x = fma_rn(beta, p, x);
}

// Blocks for a grid-stride loop over `work` items: enough to fill every SM,
// never more than the work needs, never more than `cap`.
inline int grid_for(long long work, int device, long long cap) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms < 1)
    sms = 132;
  long long g = (work + kThreads - 1) / kThreads;
  const long long fill = (long long)sms * kBlocksPerSM;
  if (g > fill) g = fill;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

// The launch shape of a one-wave kernel on one device: its SMs and the
// blocks of kThreads threads that one SM holds at once.
struct Wave {
  int sms, per_sm;
};

// Wave of `kernel` (with `smem` bytes of dynamic shared memory) on
// `device`, queried from the occupancy calculator once per device and
// kept in `cache`, a static of the caller's, so that a launch pays no query.
template <typename K>
inline cudaError_t wave_of(K kernel, size_t smem, int device, std::atomic<int> (*cache)[2],
                           Wave* w) {
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached) {
    w->sms = cache[device][0].load(std::memory_order_relaxed);
    w->per_sm = cache[device][1].load(std::memory_order_relaxed);
    if (w->sms > 0) return cudaSuccess;
  }
  cudaError_t e = cudaDeviceGetAttribute(&w->sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&w->per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (w->per_sm < 1) w->per_sm = 1;
  if (cached) {
    cache[device][1].store(w->per_sm, std::memory_order_relaxed);
    cache[device][0].store(w->sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Blocks of a one-wave launch over n elements that each block takes in
// rounds of `per_round`: one wave, never more blocks than rounds, never
// more than `cap`. It depends only on n and the card, so the order of a
// reduction's sums, and its bits, do too.
inline int wave_grid(const Wave& w, long long n, long long per_round, long long cap) {
  long long g = (long long)w.sms * w.per_sm;
  const long long rounds = (n + per_round - 1) / per_round;
  if (g > rounds) g = rounds;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

// Elements of T before the first 16-byte edge that every pointer reaches
// at the same element (x[1:], y[1:] of aligned tensors: one double or three
// floats), at most n; -1 when the pointers are off 16 bytes by different
// amounts, which only scalar loads can take.
template <typename T>
inline long long aligned_head(long long n, const void* a, const void* b, const void* c = nullptr) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(a) & 15u;
  if ((reinterpret_cast<uintptr_t>(b) & 15u) != off) return -1;
  if (c && (reinterpret_cast<uintptr_t>(c) & 15u) != off) return -1;
  if (off % sizeof(T)) return -1;
  const long long head = (long long)((16 - off) & 15u) / (long long)sizeof(T);
  return head < n ? head : n;
}

// The launch shape that a kernel's config entry point reports: blocks,
// threads per block, 16-byte packs per thread and round, blocks per SM, SMs.
inline int write_config(int* cfg, int grid, int packs, const Wave& w) {
  cfg[0] = grid;
  cfg[1] = kThreads;
  cfg[2] = packs;
  cfg[3] = w.per_sm;
  cfg[4] = w.sms;
  return 0;
}

// Sum of one value per thread over the block in a fixed order (warp
// shuffles, then one warp over the warp sums); the result is valid in
// thread 0. blockDim.x must be a multiple of 32. `scratch` holds 32 values
// in shared memory; the entry barrier lets a caller reuse it for a second sum.
template <typename A>
__device__ __forceinline__ A block_sum(A v, A* scratch) {
  __syncthreads();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? scratch[lane] : A(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The cross-block end of a one-launch reduction whose blocks each hold
// kSums per-thread sums `v`. Each block reduces them (block_sum) and
// thread 0 writes the block's partials, partial[k * gridDim.x + blockIdx.x],
// makes them visible to the card (__threadfence) and draws a ticket from
// `counter` (atomicAdd). The atomic only elects a block: the one that draws
// the last ticket reads every partial from L2 (__ldcg, past its own L1),
// sums each list in block order (thread t takes t, t + blockDim.x, ...,
// then block_sum's fixed tree), hands sum k to store(k, s) in thread 0
// and sets the counter back to 0 for the next launch on the stream. So
// the order of every sum is fixed by the grid, and a rerun gives the same
// bits. A grid of one block is its own last block.
template <int kSums, typename Store>
__device__ __forceinline__ void finish_sums(double (&v)[kSums], double* partial,
                                            unsigned int* counter, double* scratch,
                                            Store store) {
  __shared__ bool last;
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = block_sum(v[k], scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) partial[(long long)k * gridDim.x + blockIdx.x] = v[k];
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int k = 0; k < kSums; ++k) {
    double s = 0.0;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
      s += __ldcg(partial + (long long)k * gridDim.x + i);
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) store(k, s);
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// ---- mbarriers: completion of asynchronous copies into shared memory ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `count` arrivals complete a phase (1 for a barrier that one thread arms
// with mbar_expect_tx; the block's threads for cp.async arrivals).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// The calling thread arrives and the phase also waits for `bytes` of
// asynchronous copies (TMA or bulk) that name this barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- 1-D bulk copies (cp.async.bulk) into a shared-memory ring ----

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// The 16-byte aligned window of bytes that holds elements [a, b) of p:
// its start, its length, and the element offset of p + a inside it.
struct Window {
  const void* src;
  uint32_t bytes;
  int off;
};

template <typename E>
__device__ __forceinline__ Window window(const E* p, long long a, long long b) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p + a), hi = reinterpret_cast<uintptr_t>(p + b);
  const uintptr_t lo16 = lo & ~uintptr_t(15), hi16 = (hi + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const void*>(lo16), (uint32_t)(hi16 - lo16), (int)((lo - lo16) / sizeof(E))};
}

// First row r in [0, m] with indptr[r] >= key, for two keys at once, in a
// block of 2 kProbes threads: the block's lower half searches key0, the upper half key1, each with
// kProbes probes per step. The first step probes a window of kProbes rows,
// m / 2^14 apart, centred on `guess`, so that uneven rows (a grid's
// boundary planes) still fall in it; each later step is a kProbes-ary
// search of what is left: two steps in all when the guess is near. The
// loop is block-uniform.
template <int kProbes>
__device__ void find_rows(const long long* __restrict__ indptr, long long m, long long key0,
                          long long key1, long long guess0, long long guess1, long long* r0,
                          long long* r1) {
  const int half = threadIdx.x / kProbes, i = threadIdx.x % kProbes;
  const long long key = half ? key1 : key0, guess = half ? guess1 : guess0;
  long long lo = 0, hi = m;  // the answer lies in [lo, hi]
  for (bool first = true;; first = false) {
    // this step probes [a, a + span), inside [lo, hi]
    long long a = lo, span = hi - lo;
    if (first) {
      const long long w = (long long)kProbes * ((m >> 14) > 1 ? (m >> 14) : 1);
      a = guess - w / 2;
      a = a > m - w ? m - w : a;
      a = a < 0 ? 0 : a;
      span = a + w < m ? w : m - a;
    }
    const bool wide = span >= kProbes;
    const long long np = wide ? kProbes : span;
    auto probe = [&](long long j) { return wide ? a + span * j / kProbes : a + j; };
    const bool pred = i < np && __ldg(indptr + probe(i)) < key;
    const int c0 = __syncthreads_count(half == 0 && pred);
    const int c1 = __syncthreads_count(half == 1 && pred);
    const int c = half ? c1 : c0;
    if (np > 0) {
      if (c == 0) {
        hi = probe(0);
      } else {
        lo = probe(c - 1) + 1;
        if (c < np) hi = probe(c);
      }
    }
    if (!__syncthreads_or(hi > lo)) break;
  }
  if (i == 0) *(half ? r1 : r0) = lo;
  __syncthreads();
}

// ---- cp.async: element copies that complete on an mbarrier ----

// Copy one element of `bytes` (4 or 8) from global to shared memory; with
// `in` false nothing is read and the element is filled with zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, bool in) {
  static_assert(kBytes == 4 || kBytes == 8, "cp.async.ca takes 4 or 8 bytes here");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(kBytes), "r"(in ? kBytes : 0)
               : "memory");
}

// Close this thread's open cp.async copies into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every cp.async group this thread committed has landed (its
// own copies only: a block barrier after it makes the block's visible).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The barrier's pending count falls by one when every cp.async this thread
// issued so far has landed (noinc: the init count includes the arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- TMA: tiled copies of a box of a 3-D tensor ----

// One box of the tensor map at element coordinates (c0, c1, c2), innermost
// first, into shared memory (128-byte aligned), completing on `bar`.
// Coordinates may be negative or past the edge: the elements outside the
// tensor arrive as zeros, and the barrier still counts the whole box.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that no library links against libcuda; nullptr if the driver has none.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static std::atomic<void*> cached{nullptr};
  void* fn = cached.load(std::memory_order_acquire);
  if (fn) return reinterpret_cast<EncodeTiledFn>(fn);
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !fn) return nullptr;
  cached.store(fn, std::memory_order_release);
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// Encode into `out` (sizeof(CUtensorMap) bytes, any alignment) the map of a
// C-order n0 x n1 x n2 tensor of `itemsize`-byte floats at `base`, whose
// boxes are box2 x box1 x 1 elements (i2 x i1 x i0), out-of-bounds filled
// with zeros. TMA needs a 16-byte aligned base, a row pitch n2 * itemsize
// and a box row box2 * itemsize that are multiples of 16 bytes. Returns 0,
// the driver's CUresult, or -1 when the driver has no encoder.
inline int encode_tensor_map_3d(void* out, const void* base, int itemsize, long long n0,
                                long long n1, long long n2, int box2, int box1) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return -1;
  const cuuint64_t dims[3] = {(cuuint64_t)n2, (cuuint64_t)n1, (cuuint64_t)n0};
  const cuuint64_t strides[2] = {(cuuint64_t)(n2 * itemsize), (cuuint64_t)(n1 * n2 * itemsize)};
  const cuuint32_t box[3] = {(cuuint32_t)box2, (cuuint32_t)box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  alignas(64) CUtensorMap map;
  const CUresult r = fn(&map,
                        itemsize == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  memcpy(out, &map, sizeof map);
  return 0;
}

// Pass 2 of the two-pass reductions: one block sums the `nparts` per-block
// partials of each of `nsums` sums (stored one sum after the other) in a
// fixed order and writes them to result[0..nsums). No atomics, so a rerun
// on the same card gives the same bits.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
sum_partials(T* result, const double* partial, int nparts, int nsums) {
  __shared__ double scratch[32];
  for (int k = 0; k < nsums; ++k) {
    double s = 0.0;
    for (int i = threadIdx.x; i < nparts; i += blockDim.x) s += partial[(long long)k * nparts + i];
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) result[k] = (T)s;
  }
}

}  // namespace ptt
