// K2: STREAMS triad, a = b + alpha * c, f64 and f32.
//
// Replaces petsc_tpu/ops/pallas_kernels.py:108 triad (_triad :115, kernel
// _triad_kernel :96). In the CG body it is x <- x + a p and p <- z + beta p,
// and its measured bandwidth is the port's roofline.
//
// Bound: it moves 3 n itemsize bytes (b and c read once, a written once)
// over 3.35 TB/s, for 2 n flops: device-memory bandwidth. At 128^3 in f64
// that is 50.3 MB, about the L2's size.
// Design for that bound: one tile of kThreads 16-byte packs per block and
// as many blocks as tiles (up to 2^30, past which each block loops), so
// a thread issues its loads of b and c at once, stores one pack of a and
// exits, and the card's block scheduler keeps every SM full of fresh
// loads to the end. On the H100 (times in PERF.md) this beat one wave of
// persistent blocks with 2, 4 or 8 packs per thread in rounds, with
// contiguous slabs or interleaved rounds, one-round blocks of 2 or 4
// packs, and a cp.async.bulk ring with bulk stores; it was the only
// design measured that was no slower than torch.add in f64 and f32, at
// 128^3 and at 2^24 elements.
// Alignment: when a, b and c are off 16 bytes by the same amount, a scalar
// head up to the first 16-byte edge is peeled and the rest is vectorised;
// only mixed alignment takes scalar loads throughout.
// alpha is read on the card from a 0-d tensor, as the Pallas kernel reads
// it from SMEM, so a launch needs no host round trip. a may alias b or c
// (the CG body updates x and p in place): each element is read and
// written by the same thread, which loads before it stores.
#include "common.cuh"

namespace {

constexpr long long kMaxGrid = 1LL << 30;

template <typename T>
__device__ __forceinline__ T fma_of(T b, T alpha, T c) { return b + alpha * c; }

template <typename T>
__device__ __forceinline__ ptt::Pack<T> fma_of(const ptt::Pack<T>& b, T alpha, const ptt::Pack<T>& c) {
  ptt::Pack<T> o;
#pragma unroll
  for (int k = 0; k < ptt::Pack<T>::kWidth; ++k) o.v[k] = b.v[k] + alpha * c.v[k];
  return o;
}

// a = b + alpha c over `count` items E, one item per thread and tile
template <typename T, typename E>
__device__ __forceinline__ void tiles(E* a, const E* b, const E* c, T alpha, long long count) {
  const long long step = (long long)gridDim.x * ptt::kThreads;
  for (long long i = (long long)blockIdx.x * ptt::kThreads + threadIdx.x; i < count; i += step) {
    const E bv = b[i], cv = c[i];
    a[i] = fma_of(bv, alpha, cv);
  }
}

// head >= 0: elements before the first 16-byte edge of a, b and c;
// head < 0: mixed alignment.
template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
triad_kernel(T* a, const T* b, const T* c, const T* alpha_p, long long n, long long head) {
  using P = ptt::Pack<T>;
  constexpr int W = P::kWidth;
  const T alpha = *alpha_p;
  if (head >= 0) {
    const long long nv = (n - head) / W;
    tiles(reinterpret_cast<P*>(a + head), reinterpret_cast<const P*>(b + head),
          reinterpret_cast<const P*>(c + head), alpha, nv);
    // the scalar ends, in block 0: the head and the tail past the last pack
    const long long tail = head + nv * W;
    if (blockIdx.x == 0) {
      if (threadIdx.x < head) a[threadIdx.x] = b[threadIdx.x] + alpha * c[threadIdx.x];
      if (tail + threadIdx.x < n) {
        const long long i = tail + threadIdx.x;
        a[i] = b[i] + alpha * c[i];
      }
    }
  } else {
    tiles(a, b, c, alpha, n);
  }
}

// With cfg, writes the launch shape there instead of launching.
template <typename T>
int launch_triad(void* a, const void* b, const void* c, const void* alpha, long long n,
                 int device, void* stream, int* cfg) {
  PTT_TRY(cudaSetDevice(device));
  // one tile of packs per block; the same grid takes the scalar path W
  // elements per thread
  long long grid = (n + ptt::Pack<T>::kWidth * ptt::kThreads - 1) / (ptt::Pack<T>::kWidth * ptt::kThreads);
  grid = grid < 1 ? 1 : grid > kMaxGrid ? kMaxGrid : grid;
  if (cfg) {
    static std::atomic<int> cache[ptt::kMaxDevices][2];
    ptt::Wave w;
    PTT_TRY(ptt::wave_of(triad_kernel<T>, 0, device, cache, &w));
    return ptt::write_config(cfg, (int)grid, 1, w);
  }
  triad_kernel<T><<<(unsigned int)grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
      (T*)a, (const T*)b, (const T*)c, (const T*)alpha, n, ptt::aligned_head<T>(n, a, b, c));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_triad_f64(void* a, const void* b, const void* c, const void* alpha, long long n,
                             int device, void* stream) {
  return launch_triad<double>(a, b, c, alpha, n, device, stream, nullptr);
}

extern "C" int ptt_triad_f32(void* a, const void* b, const void* c, const void* alpha, long long n,
                             int device, void* stream) {
  return launch_triad<float>(a, b, c, alpha, n, device, stream, nullptr);
}

// The launch shape for n elements of f64 (or f32).
extern "C" int ptt_triad_config(int f64, long long n, int device, int* cfg) {
  return f64 ? launch_triad<double>(nullptr, nullptr, nullptr, nullptr, n, device, nullptr, cfg)
             : launch_triad<float>(nullptr, nullptr, nullptr, nullptr, n, device, nullptr, cfg);
}
