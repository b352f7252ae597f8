// K4: the dot pair, (<x, y>, <y, y>) in one pass and one launch.
//
// Replaces petsc_tpu/ops/pallas_kernels.py:198 dot2 (_dot2 :205, kernel
// _dot2_kernel :185). In the CG body it gives <w, p> for the step length
// and (<r, z>, <z, z>) for beta and the preconditioned norm.
//
// Bound: 2 n itemsize bytes (x and y read once) over 3.35 TB/s, for 4 n
// flops: device-memory bandwidth. At 128^3 in f64 that is 33.5 MB, about
// the L2's size, so the ramp of the grid and its tail are a large share.
// Design for that bound:
// - One launch: each block reduces its two sums in double (f32 inputs
//   too), and the block that draws the last ticket sums the per-block
//   partials in block order (ptt::finish_sums). The ticket's counter is
//   scratch that the wrapper owns per stream; the kernel leaves it at 0,
//   so a call needs no memset.
// - One wave: the grid is the blocks that the card holds at once (SMs
//   times the occupancy calculator's blocks per SM, queried once per
//   device), so that no block waits for a slot and the last block sums
//   few partials.
// - Every load of a round in flight at once: in each round a thread loads
//   kU = 8 16-byte packs of x and 8 of y (256 bytes) before its first
//   multiply. Block b takes rounds b, b + G, b + 2G, ... of the range, so
//   the grid streams one window of memory at a time. On the H100 this beat
//   a contiguous slab per block (5-7 % at 2^24 elements), 2, 4 or 6 packs,
//   a cp.async.bulk ring and one round per block (PERF.md has the times).
// - The grid depends only on n and the card, and so does the order of
//   every sum: reruns give the same bits.
// - Alignment: when x and y are off 16 bytes by the same amount (x[1:],
//   y[1:]), a scalar head up to the first 16-byte edge is peeled and the
//   rest is vectorised; only mixed alignment takes scalar loads throughout.
#include "common.cuh"

namespace {

constexpr int kU = 8;   // 16-byte packs of x and of y a thread loads before it multiplies

template <typename T>
__device__ __forceinline__ void acc2(double (&s)[2], T x, T y) {
  s[0] += (double)x * (double)y;
  s[1] += (double)y * (double)y;
}

// This block's rounds over `count` items E: round r covers items
// [r R, (r + 1) R), R = V kThreads, and block b takes rounds b, b + G, ...
// In a round a thread loads V items of x and V of y (item v at its index
// + v kThreads) before it sums any. A full round loads without
// conditions, so that the compiler issues every load first; the last one
// zero-fills what lies past `count`.
template <int V, typename E, typename F>
__device__ __forceinline__ void rounds(const E* __restrict__ x, const E* __restrict__ y,
                                       long long count, F&& sum) {
  const long long step = (long long)gridDim.x * V * ptt::kThreads;
  for (long long i0 = (long long)blockIdx.x * V * ptt::kThreads + threadIdx.x; i0 < count;
       i0 += step) {
    E xv[V], yv[V];
    if (i0 + (long long)(V - 1) * ptt::kThreads < count) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        xv[v] = x[i0 + (long long)v * ptt::kThreads];
        yv[v] = y[i0 + (long long)v * ptt::kThreads];
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long i = i0 + (long long)v * ptt::kThreads;
        xv[v] = i < count ? x[i] : E{};
        yv[v] = i < count ? y[i] : E{};
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) sum(xv[v], yv[v]);
  }
}

// head >= 0: elements before the first 16-byte edge of both x and y;
// head < 0: mixed alignment.
template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
dot2_kernel(T* __restrict__ result, double* __restrict__ partial, unsigned int* __restrict__ counter,
            const T* __restrict__ x, const T* __restrict__ y, long long n, long long head) {
  __shared__ double scratch[32];
  using P = ptt::Pack<T>;
  constexpr int W = P::kWidth;
  double s[2] = {0.0, 0.0};
  if (head >= 0) {
    const long long nv = (n - head) / W;
    rounds<kU>(reinterpret_cast<const P*>(x + head), reinterpret_cast<const P*>(y + head), nv,
               [&](const P& xv, const P& yv) {
#pragma unroll
                 for (int k = 0; k < W; ++k) acc2(s, xv.v[k], yv.v[k]);
               });
    // the scalar ends, in block 0: the head and the tail past the last pack
    const long long tail = head + nv * W;
    if (blockIdx.x == 0) {
      if (threadIdx.x < head) acc2(s, x[threadIdx.x], y[threadIdx.x]);
      if (tail + threadIdx.x < n) acc2(s, x[tail + threadIdx.x], y[tail + threadIdx.x]);
    }
  } else {
    rounds<kU * W>(x, y, n, [&](T xv, T yv) { acc2(s, xv, yv); });
  }
  ptt::finish_sums<2>(s, partial, counter, scratch, [&](int k, double v) { result[k] = (T)v; });
}

// With cfg, writes the launch shape there instead of launching.
template <typename T>
int launch_dot2(void* result, void* partial, void* counter, const void* x, const void* y,
                long long n, int cap, int device, void* stream, int* cfg) {
  static std::atomic<int> cache[ptt::kMaxDevices][2];
  PTT_TRY(cudaSetDevice(device));
  ptt::Wave w;
  PTT_TRY(ptt::wave_of(dot2_kernel<T>, 0, device, cache, &w));
  const long long per_round = (long long)kU * ptt::Pack<T>::kWidth * ptt::kThreads;
  const int grid = ptt::wave_grid(w, n, per_round, cap);
  if (cfg) return ptt::write_config(cfg, grid, kU, w);
  dot2_kernel<T><<<grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
      (T*)result, (double*)partial, (unsigned int*)counter, (const T*)x, (const T*)y, n,
      ptt::aligned_head<T>(n, x, y));
  return (int)cudaGetLastError();
}

}  // namespace

// partial: `cap` doubles of scratch per sum; counter: one 32-bit zero that
// every launch leaves at zero (both owned by the caller, one pair per
// stream); result: two T.
extern "C" int ptt_dot2_f64(void* result, void* partial, void* counter, const void* x,
                            const void* y, long long n, int cap, int device, void* stream) {
  return launch_dot2<double>(result, partial, counter, x, y, n, cap, device, stream, nullptr);
}

extern "C" int ptt_dot2_f32(void* result, void* partial, void* counter, const void* x,
                            const void* y, long long n, int cap, int device, void* stream) {
  return launch_dot2<float>(result, partial, counter, x, y, n, cap, device, stream, nullptr);
}

// The launch shape for n elements of f64 (or f32) with `cap` partials.
extern "C" int ptt_dot2_config(int f64, long long n, int cap, int device, int* cfg) {
  return f64 ? launch_dot2<double>(nullptr, nullptr, nullptr, nullptr, nullptr, n, cap, device,
                                   nullptr, cfg)
             : launch_dot2<float>(nullptr, nullptr, nullptr, nullptr, nullptr, n, cap, device,
                                  nullptr, cfg);
}
