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
//
// Bound: device-memory bandwidth: sum k_a^2 entries of B read once, plus r
// gathered, the dof lists and z stored once (about 61 MB in f64 at ex56 ne
// 24, level 0: 513 aggregates of up to 1,875 dofs).
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

template <typename T>
__global__ void __launch_bounds__(kAggThreads, kMinBlocks)
agg_block_kernel(T* __restrict__ z, const T* __restrict__ r, const int* __restrict__ dofs,
                 const long long* __restrict__ dptr, const T* __restrict__ inv,
                 const long long* __restrict__ iptr, const int* __restrict__ work) {
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
      T acc[kSplitRows];
      const T* row[kSplitRows];
#pragma unroll
      for (int u = 0; u < kSplitRows; ++u) {
        acc[u] = T(0);
        row[u] = B + (long long)(p + u < i0 + nr ? p + u : p) * k;
      }
      for (int j0 = threadIdx.x; j0 < k; j0 += kSplitUnroll * kAggThreads) {
        T xv[kSplitUnroll], bv[kSplitRows][kSplitUnroll];
#pragma unroll
        for (int s = 0; s < kSplitUnroll; ++s) {
          const int j = j0 + s * kAggThreads;
          xv[s] = j < k ? rs[j] : T(0);
#pragma unroll
          for (int u = 0; u < kSplitRows; ++u) bv[u][s] = j < k ? __ldg(row[u] + j) : T(0);
        }
#pragma unroll
        for (int s = 0; s < kSplitUnroll; ++s)
#pragma unroll
          for (int u = 0; u < kSplitRows; ++u) acc[u] += bv[u][s] * xv[s];
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
        z[__ldg(dq + p + threadIdx.x)] = t;
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
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const T s = group_sum(acc[u], 32);
          if (lane == 0 && i + u < hi) z[__ldg(dq + i + u)] = s;
        }
      }
    }
  } else {
    // lane groups of G: row g of the run at B + g k, its dofs at d0 + g - g % k
    const int G = k <= 1 ? 1 : 1 << (32 - __clz(k - 1));
    const int groups = kAggThreads / G, gl = threadIdx.x % G, grp = threadIdx.x / G;
    for (int base = 0; base < nr; base += groups * kRows) {
      T acc[kRows];
      int g[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        g[u] = i0 + base + u * groups + grp;
        acc[u] = T(0);
        if (gl < k && g[u] < i0 + nr) {
          const int c = g[u] - g[u] % k + gl;
          acc[u] = __ldg(B + (long long)g[u] * k + gl) * __ldg(r + __ldg(dofs + d0 + c));
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const T s = group_sum(acc[u], G);
        if (gl == 0 && g[u] < i0 + nr) z[__ldg(dofs + d0 + g[u])] = s;
      }
    }
  }
}

// `stage`: the most values of r that one item stages (the wrapper's
// agg_stage), the dynamic shared memory of every thread block
template <typename T>
int launch_agg(void* z, const void* r, const void* dofs, const void* dptr, const void* inv,
               const void* iptr, const void* work, int nitems, int stage, int device,
               void* stream) {
  PTT_TRY(cudaSetDevice(device));
  if (nitems <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)stage * sizeof(T);
  if (smem > kDefaultSmem)
    PTT_TRY(cudaFuncSetAttribute(agg_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
  agg_block_kernel<T><<<nitems, kAggThreads, smem, (cudaStream_t)stream>>>(
      (T*)z, (const T*)r, (const int*)dofs, (const long long*)dptr, (const T*)inv,
      (const long long*)iptr, (const int*)work);
  return (int)cudaGetLastError();
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
