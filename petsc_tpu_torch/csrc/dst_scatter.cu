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
// fieldsplit's scatter-set (petsc_tpu/pc/more_pc.py:595-596), fetidp's
// jump operator B and its transpose (petsc_tpu/ksp/fetidp.py:114-131), the
// DS residual's scatter-add (petsc_tpu/dm/fe.py:1403), and FVPlex's face
// flux scatter and its limiter's two scatter-mins
// (petsc_tpu/dm/fv_plex.py:225-227, 245-246).
//
// Tables, built once at set-up (ops/pc_kernels.py scatter_table): the
// entries sorted by destination, stably, as CSR row pointers ptr (n + 1),
// the source index sel and the optional weight w of each entry, and the
// list of long destinations, those with more than kLongRun entries, each
// as (destination, first entry, end). Every destination is summed by one
// thread from 0 in its entries' order, so no two threads write one word,
// no atomics are used and the bits do not depend on the grid. Products and
// sums are rounded one by one (__dmul_rn, __dadd_rn: no contraction to an
// FMA), so the result equals the plain version's bit for bit. Modes: add
// (every destination written, 0 where no entry lands), set (a destination
// with no entry keeps its value), signed (add with w = +-1, or +-scale),
// min (y[d] = min(y[d], w_k src[sel_k] over its entries), NaN propagating
// as torch.minimum does; order-free, so also equal bits).
//
// Bound: device-memory bandwidth: ptr, sel, w and the long list read once,
// y written once and the 32-byte sectors of src that sel touches read
// once; one multiply (weighted) and one add per entry. Each destination is
// a chain of three dependent loads (ptr, then sel, then src), so what
// bounds the design is how many chains are in flight.
//
// Design, one launch of two parts:
// - Short destinations (at most kLongRun entries): a thread takes kJ
//   destinations, kThreads apart (coalesced), and loads all their row
//   pointers at once, then the first kBatch entries of each (sel and w),
//   then their sources, so kJ x kBatch chains are in flight in each
//   thread; longer runs go on a batch at a time. The grid has a block for
//   every kJ x kThreads destinations, with no stride cap: kJ = 1 while
//   that fills at most one wave, else 2.
// - Long destinations: a warp each, in the first blocks of the grid. The
//   lanes load the run's entries and sources in chunks of 32 x kChunk
//   (coalesced sel and w, a gather of src), a chunk ahead of the sum, and
//   form the products in parallel into shared memory; lane 0 then adds
//   them in entry order while the next chunk comes in, so the bits stay
//   the plain version's.
// A table without long destinations (every table of the solver paths)
// launches the short part alone, whose kernel has its own register count
// (kMinBlocks blocks an SM), so the long part's registers do not thin out
// the short part's chains; a table with both kinds launches one kernel
// holding both.
#include "common.cuh"

namespace {

constexpr int kLongRun = 32;       // longer runs are the long part's (pc_kernels.LONG_RUN)
constexpr int kBatch = 2;          // entries of a short run whose loads are in flight together
constexpr int kChunk = 4;          // entries a lane loads per chunk of a long run
constexpr int kMinBlocks = 6;      // blocks an SM holds: the short part alone (40 registers)
constexpr int kMinBlocksLong = 4;  // with the long part (64 registers)
constexpr int kWarps = ptt::kThreads / 32;
constexpr int kModeAdd = 0, kModeSet = 1, kModeMin = 2;   // pc_kernels.X1_MODES

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
// torch.minimum's min: a NaN on either side wins
template <typename T>
__device__ __forceinline__ T min_nan(T acc, T v) { return (v != v || v < acc) ? v : acc; }
template <bool kMin, typename T>
__device__ __forceinline__ T combine(T acc, T v) { return kMin ? min_nan(acc, v) : add_rn(acc, v); }

// kJ destinations from `first`, kThreads apart, one thread.
template <bool kWeighted, bool kMin, int kJ, typename T>
__device__ __forceinline__ void short_part(T* __restrict__ y, const T* __restrict__ src,
                                           const int* __restrict__ ptr,
                                           const int* __restrict__ sel,
                                           const T* __restrict__ w, long long n, int skip_empty,
                                           long long first) {
  int s[kJ], e[kJ];
  T acc[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const long long d = first + (long long)j * blockDim.x + threadIdx.x;
    s[j] = e[j] = 0;
    if (d < n) {
      s[j] = __ldg(ptr + d);
      e[j] = __ldg(ptr + d + 1);
    }
    acc[j] = kMin && d < n ? y[d] : T(0);
  }
  bool mine[kJ];                       // a long run is the long part's
#pragma unroll
  for (int j = 0; j < kJ; ++j) mine[j] = e[j] - s[j] <= kLongRun;
  for (int b = 0;; b += kBatch) {
    int sl[kJ][kBatch];
    T wv[kJ][kBatch], v[kJ][kBatch];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const int k = s[j] + b + m;
        const bool live = mine[j] && k < e[j];
        sl[j][m] = live ? __ldg(sel + k) : -1;
        if (kWeighted) wv[j][m] = live ? __ldg(w + k) : T(0);
        any |= live;
      }
    }
    if (!any) break;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int m = 0; m < kBatch; ++m) v[j][m] = sl[j][m] >= 0 ? __ldg(src + sl[j][m]) : T(0);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        if (sl[j][m] >= 0)
          acc[j] = combine<kMin>(acc[j], kWeighted ? mul_rn(wv[j][m], v[j][m]) : v[j][m]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const long long d = first + (long long)j * blockDim.x + threadIdx.x;
    if (d < n && mine[j] && !(skip_empty && s[j] == e[j])) y[d] = acc[j];
  }
}

// One long destination per warp: longs[3 li .. 3 li + 2] = (d, e0, e1).
// lbuf holds the warp's products of one chunk for lane 0's in-order sum.
template <bool kWeighted, bool kMin, typename T>
__device__ __forceinline__ void long_part(T* __restrict__ y, const T* __restrict__ src,
                                          const int* __restrict__ sel, const T* __restrict__ w,
                                          const int* __restrict__ longs, int nlong, T* lbuf) {
  constexpr int kSpan = 32 * kChunk;
  const int lane = threadIdx.x & 31;
  const int li = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (li >= nlong) return;             // the whole warp
  const int d = __ldg(longs + 3 * li), e0 = __ldg(longs + 3 * li + 1);
  const int e1 = __ldg(longs + 3 * li + 2);
  // lane l holds entries c0 + 32 u + l of the chunk at c0; sl is a chunk
  // ahead of vn and wn, and they are a chunk ahead of the sum
  int sl[kChunk];
  T vn[kChunk], wn[kChunk];
  auto load_sel = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = c0 + 32 * u + lane;
      sl[u] = k < e1 ? __ldg(sel + k) : -1;
    }
  };
  auto load_vals = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = c0 + 32 * u + lane;
      vn[u] = sl[u] >= 0 ? __ldg(src + sl[u]) : T(0);
      if (kWeighted) wn[u] = k < e1 ? __ldg(w + k) : T(0);
    }
  };
  load_sel(e0);
  load_vals(e0);
  load_sel(e0 + kSpan);
  T acc = kMin ? y[d] : T(0);
  for (int c0 = e0; c0 < e1; c0 += kSpan) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) lbuf[32 * u + lane] = kWeighted ? mul_rn(wn[u], vn[u]) : vn[u];
    __syncwarp();
    if (c0 + kSpan < e1) {
      load_vals(c0 + kSpan);
      load_sel(c0 + 2 * kSpan);
    }
    if (lane == 0) {                   // in entry order, while the next chunk comes in;
      const int cnt = e1 - c0 < kSpan ? e1 - c0 : kSpan;   // the next 8 read ahead
      int k = 0;
      T r[8];
      if (cnt >= 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) r[i] = lbuf[i];
        for (; k + 16 <= cnt; k += 8) {
          T q[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) q[i] = lbuf[k + 8 + i];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc = combine<kMin>(acc, r[i]);
#pragma unroll
          for (int i = 0; i < 8; ++i) r[i] = q[i];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = combine<kMin>(acc, r[i]);
        k += 8;
      }
      for (; k < cnt; ++k) acc = combine<kMin>(acc, lbuf[k]);
    }
    __syncwarp();
  }
  if (lane == 0) y[d] = acc;
}

// kLong: the table has long destinations, whose warps take the first
// long_blocks blocks; without them the kernel is the short part alone, with
// its own (lower) register count.
template <bool kWeighted, bool kMin, bool kLong, int kJ, typename T>
__global__ void __launch_bounds__(ptt::kThreads, kLong ? kMinBlocksLong : kMinBlocks)
dst_scatter_kernel(T* __restrict__ y, const T* __restrict__ src, const int* __restrict__ ptr,
                   const int* __restrict__ sel, const T* __restrict__ w,
                   const int* __restrict__ longs, long long n, int nlong, int long_blocks,
                   int skip_empty) {
  if (kLong && (int)blockIdx.x < long_blocks) {
    __shared__ T lbuf[kWarps][32 * kChunk];
    long_part<kWeighted, kMin>(y, src, sel, w, longs, nlong, lbuf[threadIdx.x >> 5]);
    return;
  }
  short_part<kWeighted, kMin, kJ>(y, src, ptr, sel, w, n, skip_empty,
                            (long long)(blockIdx.x - long_blocks) * kJ * blockDim.x);
}

template <bool kLong, int kJ, typename T>
int launch_kernel(bool weighted, void* y, const void* src, const void* ptr, const void* sel,
                  const void* w, const void* longs, long long n, int nlong, int mode,
                  void* stream) {
  const long long per_block = (long long)kJ * ptt::kThreads;
  const long long long_blocks = (nlong + kWarps - 1) / kWarps;
  const long long grid = (n + per_block - 1) / per_block + long_blocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool mn = mode == kModeMin;
  auto k = weighted ? (mn ? dst_scatter_kernel<true, true, kLong, kJ, T>
                          : dst_scatter_kernel<true, false, kLong, kJ, T>)
                    : (mn ? dst_scatter_kernel<false, true, kLong, kJ, T>
                          : dst_scatter_kernel<false, false, kLong, kJ, T>);
  const int skip_empty = mode != kModeAdd;   // set and min keep an empty row
  k<<<(int)grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
      (T*)y, (const T*)src, (const int*)ptr, (const int*)sel, (const T*)w, (const int*)longs, n,
      nlong, (int)long_blocks, skip_empty);
  return (int)cudaGetLastError();
}

// With long destinations, the kernel with both parts (two short
// destinations a thread); without, the short part alone: a destination a
// thread while the grid fits one wave (more threads, as for
// fetidp's 14,880 jump rows), else two (two chains a thread).
template <typename T>
int launch(void* y, const void* src, const void* ptr, const void* sel, const void* w,
           const void* longs, long long n, int nlong, int mode, int device, void* stream) {
  static_assert(ptt::kThreads % 32 == 0, "whole warps");
  static std::atomic<int> cache[ptt::kMaxDevices][2];
  PTT_TRY(cudaSetDevice(device));
  if (!longs) nlong = 0;
  if (n == 0 && nlong == 0) return 0;
  if (mode < kModeAdd || mode > kModeMin) return (int)cudaErrorInvalidValue;
  const bool weighted = w != nullptr;
  if (nlong > 0)
    return launch_kernel<true, 2, T>(weighted, y, src, ptr, sel, w, longs, n, nlong, mode,
                                     stream);
  ptt::Wave wv;
  PTT_TRY(ptt::wave_of(dst_scatter_kernel<true, false, false, 1, T>, 0, device, cache, &wv));
  if (n <= (long long)wv.sms * wv.per_sm * ptt::kThreads)
    return launch_kernel<false, 1, T>(weighted, y, src, ptr, sel, w, longs, n, 0, mode, stream);
  return launch_kernel<false, 2, T>(weighted, y, src, ptr, sel, w, longs, n, 0, mode, stream);
}

}  // namespace

extern "C" int ptt_dst_scatter_f64(void* y, const void* src, const void* ptr, const void* sel,
                                   const void* w, const void* longs, long long n, int nlong,
                                   int mode, int device, void* stream) {
  return launch<double>(y, src, ptr, sel, w, longs, n, nlong, mode, device, stream);
}

extern "C" int ptt_dst_scatter_f32(void* y, const void* src, const void* ptr, const void* sel,
                                   const void* w, const void* longs, long long n, int nlong,
                                   int mode, int device, void* stream) {
  return launch<float>(y, src, ptr, sel, w, longs, n, nlong, mode, device, stream);
}
