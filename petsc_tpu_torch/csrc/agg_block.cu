// A1: the aggregate-block smoother's apply z = M^-1 r, f64 and f32.
//
// Replaces the apply of -pc_gamg_asm_use_agg in petsc_tpu/pc/mg.py:516-525
// (gather r over each aggregate's dofs, a batched GEMV with the dense
// inverse of the aggregate's diagonal block, scatter-add; left to XLA on the
// TPU, with every block padded to the largest). Here the tables are ragged:
// aggregate a has k_a dofs d_a (dofs[dptr[a] : dptr[a+1]]) and its k_a x k_a
// inverse B_a row-major at inv[iptr[a] :]. Aggregates are disjoint and cover
// every dof (a dof outside all of them is a 1 x 1 block), so
//   z[d_a] = B_a r[d_a]
// stores each entry of z once, with no atomics.
// The Chebyshev smoother (petsc_tpu_torch/ksp/cheby.py) only reads z to
// finish its step with C1's z mode (cheby.cu), so a second entry point
// takes that step as the kernel's epilogue: where z[d] would be stored,
//   first_z:  p[d] = c z;  step_z:  p[d] = a p[d] + c z;  then x[d] += beta p[d]
// in place, and no z is written or read back: one launch per step, not two.
//
// Bound: device-memory bandwidth: sum k_a^2 entries of B read once, plus r
// gathered, the dof lists and z stored once (about 61 MB in f64 at ex56 ne
// 24, level 0: 513 aggregates of up to 1,875 dofs); with the epilogue x is
// read and written and p written (first_z) or also read (step_z) in place
// of z's store.
// Design for that bound: the blocks come grouped by size, so a run of
// blocks of one size k is a list of rows of k entries each, row g at
// inv[iptr[first] + g k], its dofs from dofs[dptr[first] + g - g % k].
// One work item per thread block of 256 threads, a range of rows of such a
// run of about a fixed number of entries (the wrapper's work list: whole
// blocks when k^2 is below it, else rows of one block, in block order), so
// the items are even and a block of 1,875 dofs spreads over many.
// For k > kSmallK the item's thread block first gathers r over the dofs of
// the blocks its rows lie in into shared memory (dofs for kStageCols columns
// per thread loaded before any r, so two loads deep), so that a pass over rows
// waits for one load, not for the dofs and then r. Three mappings by k:
// - k >= kSplitK (a large block): the block's 256 threads share each row's
//   columns, kSplitRows rows per pass, kSplitUnroll column steps
//   issued together: a chain of k / (256 kSplitUnroll) loads per pass
//   (4 at k = 1,875), not k / 32 as a warp per row walks it. Each row's
//   partial sums meet through shuffles and one shared-memory sum per warp.
// - 16 < k < kSplitK: each warp takes kRows rows of one block at once, its
//   lanes along the row (a warp's load is 32 consecutive entries), kUnroll
//   steps issued together: kRows x kUnroll independent loads of B in flight
//   per lane, each staged r[d] read once for the kRows rows.
// - k <= 16: groups of G lanes (G the power of two at or above k) take a
//   row each, neighbouring groups neighbouring rows, so a warp's load is
//   contiguous; kRows rows per group in flight.
// The sums are in another order than the plain version's batched product,
// so the two agree to rounding (the tolerance chip_smoke.py states). The
// parts and constants were measured with a1_probe.py (PERF.md).
#include "common.cuh"

namespace {

constexpr int kAggThreads = 256;
constexpr int kWarps = kAggThreads / 32;
constexpr int kRows = 4;         // rows in flight per warp (16 < k < kSplitK) or lane group
constexpr int kUnroll = 4;       // steps of 32 entries of a row issued together (warp rows)
constexpr int kSmallK = 16;      // the largest k taken by lane groups
constexpr int kSplitK = 512;     // the smallest k whose rows the whole thread block shares
constexpr int kSplitRows = 8;    // rows of one pass at k >= kSplitK
constexpr int kSplitUnroll = 2;  // column steps of 256 issued together at k >= kSplitK
constexpr int kStageCols = 4;    // columns per thread of one round of the staging of r
constexpr int kMinBlocks = 2;    // thread blocks per SM the registers must allow (3 spills)
// The f32 z-only kernel fits 3 blocks per SM unbounded (80 registers); the
// fused one is held to that (unbounded it took 86, and 2 blocks per SM)
template <typename T>
constexpr int kMinBlocksFused = sizeof(T) == 4 ? 3 : kMinBlocks;
constexpr int kDefaultSmem = 48 * 1024;

template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rs[j] = r[ds[j]] for j < n by the thread block, dofs for kStageCols
// columns per thread loaded before any r, so the chain is two loads deep
template <typename T>
__device__ __forceinline__ void stage_r(T* rs, const T* __restrict__ r,
                                        const int* __restrict__ ds, int n) {
  for (int j0 = threadIdx.x; j0 < n; j0 += kStageCols * kAggThreads) {
    int d[kStageCols];
#pragma unroll
    for (int q = 0; q < kStageCols; ++q) {
      const int j = j0 + q * kAggThreads;
      d[q] = j < n ? __ldg(ds + j) : 0;
    }
    T v[kStageCols];
#pragma unroll
    for (int q = 0; q < kStageCols; ++q) v[q] = j0 + q * kAggThreads < n ? __ldg(r + d[q]) : T(0);
#pragma unroll
    for (int q = 0; q < kStageCols; ++q)
      if (j0 + q * kAggThreads < n) rs[j0 + q * kAggThreads] = v[q];
  }
  __syncthreads();
}

// What the kernel does at the store of each entry s = (B_a r[d_a])_i, for
// its dof d: kStoreZ stores z[d] = s; kFirstZ and kStepZ finish C1's z mode
// there instead (ptt::cheby_z_update: p[d] = c s, or a p[d] + c s, then
// x[d] += beta p[d]) and store no z. Each dof is stored once, by one
// thread, so p and x are read and written in place with no race; the
// operands p[d] and x[d] are loaded before the row's sum.
enum Epilogue { kStoreZ, kFirstZ, kStepZ };

template <int kEpi, typename T>
__device__ __forceinline__ void load_px(const T* pv, const T* xv, int d, T& p, T& x) {
  x = xv[d];
  p = kEpi == kStepZ ? pv[d] : T(0);
}

template <int kEpi, typename T>
__device__ __forceinline__ void finish_px(T* pv, T* xv, int d, T s, T p, T x, T a, T c,
                                          T beta) {
  ptt::cheby_z_update<kEpi == kFirstZ>(p, x, s, a, c, beta);
  pv[d] = p;
  xv[d] = x;
}

// z (kStoreZ) or p and x (the z modes) from r, over the item of this block
template <int kEpi, typename T>
__device__ __forceinline__ void agg_block_item(
    T* __restrict__ z, T* __restrict__ pv, T* __restrict__ xv, T a, T c, T beta,
    const T* __restrict__ r, const int* __restrict__ dofs, const long long* __restrict__ dptr,
    const T* __restrict__ inv, const long long* __restrict__ iptr,
    const int* __restrict__ work) {
  const int blk = __ldg(work + 3 * (long long)blockIdx.x);
  const int i0 = __ldg(work + 3 * (long long)blockIdx.x + 1);
  const int nr = __ldg(work + 3 * (long long)blockIdx.x + 2);
  const long long d0 = __ldg(dptr + blk);
  const int k = (int)(__ldg(dptr + blk + 1) - d0);
  const T* B = inv + __ldg(iptr + blk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);   // r over the item's blocks (k > kSmallK)

  if (k >= kSplitK) {
    // rows [i0, i0 + nr) of one block; r over its dofs staged once
    __shared__ T part[kWarps][kSplitRows];
    const int* dq = dofs + d0;
    stage_r(rs, r, dq, k);
    for (int p = i0; p < i0 + nr; p += kSplitRows) {
      // (the z modes) thread t < kSplitRows stores row p + t
      int d = 0;
      T pd = T(0), xd = T(0);
      if constexpr (kEpi != kStoreZ) {
        if (threadIdx.x < kSplitRows && p + threadIdx.x < i0 + nr) {
          d = __ldg(dq + p + threadIdx.x);
          load_px<kEpi>(pv, xv, d, pd, xd);
        }
      }
      T acc[kSplitRows];
      const T* row[kSplitRows];
#pragma unroll
      for (int u = 0; u < kSplitRows; ++u) {
        acc[u] = T(0);
        row[u] = B + (long long)(p + u < i0 + nr ? p + u : p) * k;
      }
      for (int j0 = threadIdx.x; j0 < k; j0 += kSplitUnroll * kAggThreads) {
        T rv[kSplitUnroll], bv[kSplitRows][kSplitUnroll];
#pragma unroll
        for (int s = 0; s < kSplitUnroll; ++s) {
          const int j = j0 + s * kAggThreads;
          rv[s] = j < k ? rs[j] : T(0);
#pragma unroll
          for (int u = 0; u < kSplitRows; ++u) bv[u][s] = j < k ? __ldg(row[u] + j) : T(0);
        }
#pragma unroll
        for (int s = 0; s < kSplitUnroll; ++s)
#pragma unroll
          for (int u = 0; u < kSplitRows; ++u) acc[u] += bv[u][s] * rv[s];
      }
#pragma unroll
      for (int u = 0; u < kSplitRows; ++u) {
        const T w = group_sum(acc[u], 32);
        if (lane == 0) part[warp][u] = w;
      }
      __syncthreads();
      if (threadIdx.x < kSplitRows && p + threadIdx.x < i0 + nr) {
        T t = part[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) t += part[w][threadIdx.x];
        if constexpr (kEpi == kStoreZ)
          z[__ldg(dq + p + threadIdx.x)] = t;
        else
          finish_px<kEpi>(pv, xv, d, t, pd, xd, a, c, beta);
      }
      __syncthreads();
    }
  } else if (k > kSmallK) {
    // the item's rows [i0, i0 + nr) lie in blocks q0 = i0 / k, ... of the
    // run; r over their dofs staged once
    const int g_end = i0 + nr, q0 = i0 / k;
    stage_r(rs, r, dofs + d0 + (long long)q0 * k, ((g_end + k - 1) / k - q0) * k);
    for (int q = q0; q * k < g_end; ++q) {
      const int lo = (i0 > q * k ? i0 : q * k) - q * k;
      const int hi = (g_end < (q + 1) * k ? g_end : (q + 1) * k) - q * k;
      const int* dq = dofs + d0 + (long long)q * k;
      const T* rq = rs + (q - q0) * k;
      const T* Bq = B + (long long)q * k * k;
      for (int i = lo + warp * kRows; i < hi; i += kWarps * kRows) {
        // (the z modes) lane u < kRows stores row i + u
        int d = 0;
        T pd = T(0), xd = T(0);
        if constexpr (kEpi != kStoreZ) {
          if (lane < kRows && i + lane < hi) {
            d = __ldg(dq + i + lane);
            load_px<kEpi>(pv, xv, d, pd, xd);
          }
        }
        T acc[kRows];
        const T* row[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          acc[u] = T(0);
          row[u] = Bq + (long long)(i + u < hi ? i + u : i) * k;
        }
        for (int j0 = 0; j0 < k; j0 += 32 * kUnroll) {
          T rv[kUnroll], bv[kRows][kUnroll];
#pragma unroll
          for (int s = 0; s < kUnroll; ++s) {
            const int j = j0 + 32 * s + lane;
            rv[s] = j < k ? rq[j] : T(0);
#pragma unroll
            for (int u = 0; u < kRows; ++u) bv[u][s] = j < k ? __ldg(row[u] + j) : T(0);
          }
#pragma unroll
          for (int s = 0; s < kUnroll; ++s)
#pragma unroll
            for (int u = 0; u < kRows; ++u) acc[u] += bv[u][s] * rv[s];
        }
        T own = T(0);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const T s = group_sum(acc[u], 32);   // the same bits in every lane
          if constexpr (kEpi == kStoreZ) {
            if (lane == 0 && i + u < hi) z[__ldg(dq + i + u)] = s;
          } else if (lane == u) {
            own = s;
          }
        }
        if constexpr (kEpi != kStoreZ)
          if (lane < kRows && i + lane < hi) finish_px<kEpi>(pv, xv, d, own, pd, xd, a, c, beta);
      }
    }
  } else {
    // lane groups of G: row g of the run at B + g k, its dofs at d0 + g - g % k
    const int G = k <= 1 ? 1 : 1 << (32 - __clz(k - 1));
    const int groups = kAggThreads / G, gl = threadIdx.x % G, grp = threadIdx.x / G;
    for (int base = 0; base < nr; base += groups * kRows) {
      T acc[kRows];
      int g[kRows];
      // (the z modes) each group's lane 0 stores its rows g[u]
      int d[kRows];
      T pd[kRows], xd[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        g[u] = i0 + base + u * groups + grp;
        if constexpr (kEpi != kStoreZ) {
          d[u] = 0;
          pd[u] = xd[u] = T(0);
          if (gl == 0 && g[u] < i0 + nr) {
            d[u] = __ldg(dofs + d0 + g[u]);
            load_px<kEpi>(pv, xv, d[u], pd[u], xd[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        acc[u] = T(0);
        if (gl < k && g[u] < i0 + nr) {
          const int col = g[u] - g[u] % k + gl;
          acc[u] = __ldg(B + (long long)g[u] * k + gl) * __ldg(r + __ldg(dofs + d0 + col));
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const T s = group_sum(acc[u], G);
        if (gl == 0 && g[u] < i0 + nr) {
          if constexpr (kEpi == kStoreZ)
            z[__ldg(dofs + d0 + g[u])] = s;
          else
            finish_px<kEpi>(pv, xv, d[u], s, pd[u], xd[u], a, c, beta);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAggThreads, kMinBlocks)
agg_block_kernel(T* __restrict__ z, const T* __restrict__ r, const int* __restrict__ dofs,
                 const long long* __restrict__ dptr, const T* __restrict__ inv,
                 const long long* __restrict__ iptr, const int* __restrict__ work) {
  agg_block_item<kStoreZ>(z, (T*)nullptr, (T*)nullptr, T(0), T(0), T(0), r, dofs, dptr, inv,
                          iptr, work);
}

// A1 with C1's z mode as its epilogue: one launch per smoothing step
template <int kEpi, typename T>
__global__ void __launch_bounds__(kAggThreads, kMinBlocksFused<T>)
agg_block_cheby_kernel(T* __restrict__ p, T* __restrict__ x, T a, T c, T beta,
                       const T* __restrict__ r, const int* __restrict__ dofs,
                       const long long* __restrict__ dptr, const T* __restrict__ inv,
                       const long long* __restrict__ iptr, const int* __restrict__ work) {
  agg_block_item<kEpi>((T*)nullptr, p, x, a, c, beta, r, dofs, dptr, inv, iptr, work);
}

// `stage`: the most values of r that one item stages (the wrapper's
// agg_stage), the dynamic shared memory of every thread block
template <typename T, typename Kernel, typename... Args>
int launch_items(Kernel kernel, int nitems, int stage, int device, void* stream, Args... args) {
  PTT_TRY(cudaSetDevice(device));
  if (nitems <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)stage * sizeof(T);
  if (smem > kDefaultSmem)
    PTT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kernel<<<nitems, kAggThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_agg(void* z, const void* r, const void* dofs, const void* dptr, const void* inv,
               const void* iptr, const void* work, int nitems, int stage, int device,
               void* stream) {
  return launch_items<T>(agg_block_kernel<T>, nitems, stage, device, stream, (T*)z,
                         (const T*)r, (const int*)dofs, (const long long*)dptr, (const T*)inv,
                         (const long long*)iptr, (const int*)work);
}

// mode 0: first_z, 1: step_z; a, c and beta rounded to T, as cheby.cu does
template <typename T>
int launch_agg_cheby(int mode, void* p, void* x, const void* r, const void* dofs,
                     const void* dptr, const void* inv, const void* iptr, const void* work,
                     int nitems, int stage, double a, double c, double beta, int device,
                     void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  return launch_items<T>(mode == 0 ? agg_block_cheby_kernel<kFirstZ, T>
                                   : agg_block_cheby_kernel<kStepZ, T>,
                         nitems, stage, device, stream, (T*)p, (T*)x, (T)a, (T)c, (T)beta,
                         (const T*)r, (const int*)dofs, (const long long*)dptr, (const T*)inv,
                         (const long long*)iptr, (const int*)work);
}

}  // namespace

extern "C" int ptt_agg_block_apply_f64(void* z, const void* r, const void* dofs, const void* dptr,
                                       const void* inv, const void* iptr, const void* work,
                                       int nitems, int stage, int device, void* stream) {
  return launch_agg<double>(z, r, dofs, dptr, inv, iptr, work, nitems, stage, device, stream);
}

extern "C" int ptt_agg_block_apply_f32(void* z, const void* r, const void* dofs, const void* dptr,
                                       const void* inv, const void* iptr, const void* work,
                                       int nitems, int stage, int device, void* stream) {
  return launch_agg<float>(z, r, dofs, dptr, inv, iptr, work, nitems, stage, device, stream);
}

extern "C" int ptt_agg_block_cheby_f64(int mode, void* p, void* x, const void* r,
                                       const void* dofs, const void* dptr, const void* inv,
                                       const void* iptr, const void* work, int nitems,
                                       int stage, double a, double c, double beta, int device,
                                       void* stream) {
  return launch_agg_cheby<double>(mode, p, x, r, dofs, dptr, inv, iptr, work, nitems, stage, a,
                                  c, beta, device, stream);
}

extern "C" int ptt_agg_block_cheby_f32(int mode, void* p, void* x, const void* r,
                                       const void* dofs, const void* dptr, const void* inv,
                                       const void* iptr, const void* work, int nitems,
                                       int stage, double a, double c, double beta, int device,
                                       void* stream) {
  return launch_agg_cheby<float>(mode, p, x, r, dofs, dptr, inv, iptr, work, nitems, stage, a,
                                 c, beta, device, stream);
}
