// Helpers shared by the hand-written Hopper kernels of petsc_tpu_torch.
//
// Every kernel is built for sm_90a with a plain C entry point that the
// Python wrappers in petsc_tpu_torch/ops/pallas_kernels.py load with
// ctypes. An entry point sets the device, launches on the stream it is
// given, never synchronises, and returns cudaGetLastError() so that a
// refused launch is reported to the wrapper, which raises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
