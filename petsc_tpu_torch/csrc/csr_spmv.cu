// S2: the general CSR SpMV  y[i] = sum_{k in [indptr[i], indptr[i+1])} vals[k] * x[col[k]],
// f64 and f32.
//
// Replaces petsc_tpu/mat/aij.py:1554-1561 (_bind_aij_csr mult), which the
// TPU ran as XLA's gather plus segment_sum (petsc_tpu/ops/spmv.py:45-47
// csr_seg_spmv). The TPU has no hardware gather; Hopper has one, so the
// product is one pass over the CSR arrays.
//
// Bound: nnz * (itemsize + 4) + (m + 1) * 8 + 2 * m * itemsize bytes (vals
// and col streamed once, indptr read once, x read once, y written once)
// over 3.35 TB/s, for 2 nnz flops: device-memory bandwidth. On 128^3 box27
// the matrix is 0.67 GB, 13 times the 50 MB L2, so every product streams
// it from HBM; x (16.8 MB) is read again for each entry that names it and
// those reads are served by L1 and L2.
//
// Design: tiles of kTile consecutive entries, not rows. A persistent grid
// (the blocks that fit on the card at once) splits the tiles into equal
// contiguous runs; a block owns every row whose first entry lies in its
// run, found by two block-wide searches over indptr at the start, and
// reads those rows to their ends, which may lie past the run. Each row has
// one owner, so no atomics and no second pass.
// - Stream: the block walks its entries in chunks cut at the multiples of
//   kTile. Thread 0 copies each chunk's vals and col into a ring of
//   kRingStages shared-memory stages with the 1-D bulk copy
//   (cp.async.bulk, completed on an mbarrier, with an L2 evict-first
//   policy: the matrix is read once), kRingStages - 1 chunks ahead of the
//   one being reduced. The copy takes 16-byte aligned windows, rounded out
//   at both ends, and the kernel indexes from the offset, so vals and col
//   may start at any element.
// - Multiply: every thread gathers x[col] (read-only path) for its kPer
//   entries of the next chunk before the current chunk is reduced, and
//   stores vals * x[col] in place after, so the gathers' latency hides
//   behind the reduction.
// - Reduce: groups of kGroup lanes reduce one row each from shared memory:
//   lane j sums the row's entries j, j + kGroup, ... of the chunk in order,
//   then a fixed shuffle tree. A row that runs past a chunk carries its
//   partial sum to the next chunk in shared memory (carry + partial, in
//   chunk order). Chunk edges sit at multiples of kTile whatever the grid,
//   so a rerun, or a card with another SM count, gives the same bits. Each
//   batch of kGroups rows stores its y entries to consecutive addresses.
//   One block barrier per chunk (more when its rows need more batches).
// What bounds it on the H100 (PERF.md, PR 3): the ring alone moves the
// matrix at about 2.8 TB/s, and the multiply and reduce alone take about
// nine tenths of that time, so the two overlap only in part; the
// constants (512 threads, 2048-entry tiles, four stages, four lanes per
// row) were chosen with s2_sweep.py.
// A row longer than many tiles is right but summed by one group of a
// single block: such a matrix is load-imbalanced. indptr is int64 (rows of
// any length); col is int32, so the wrapper takes at most 2^31 - 1 columns.
#include "common.cuh"

namespace {

constexpr int kBlockThreads = 512;                // threads per block
constexpr int kTile = 2048;                       // entries per tile and chunk, f64 and f32
constexpr int kRingStages = 4;                    // chunks in the ring
constexpr int kGroup = 4;                         // lanes that reduce one row
constexpr int kGroups = kBlockThreads / kGroup;   // rows reduced per batch
constexpr int kProbes = kBlockThreads / 2;        // probes of each of the two searches
constexpr int kPer = kTile / kBlockThreads;       // entries per thread per chunk
static_assert(kTile % kBlockThreads == 0, "a tile is whole rounds of the block");

// one stage of the ring holds a chunk's vals and col windows, with 16
// bytes of slack for the rounding at each end
template <typename T>
struct Ring {
  static constexpr int kVal = kTile * (int)sizeof(T) + 32;
  static constexpr int kCol = kTile * 4 + 32;
  static constexpr int kBytes = kRingStages * (kVal + kCol);
};

using ptt::mbar_expect_tx;
using ptt::mbar_init;
using ptt::mbar_wait;
using ptt::smem_u32;
using ptt::bulk_load;
using ptt::l2_policy_evict_first;
using ptt::prefetch_l2;
using ptt::window;
using ptt::Window;

// The end of the chunk that starts at entry c0: the next multiple of the
// tile, or the block's last entry.
__device__ __forceinline__ long long chunk_end(long long c0, long long e_end) {
  const long long b = (c0 / kTile + 1) * kTile;
  return b < e_end ? b : e_end;
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
csr_spmv_kernel(T* __restrict__ y, const long long* __restrict__ indptr,
                const int* __restrict__ col, const T* __restrict__ vals,
                const T* __restrict__ x, long long m, long long nnz) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kRingStages];
  __shared__ T carry[2];
  __shared__ long long rows[2];

  const int tid = threadIdx.x, lane = tid % kGroup, g = tid / kGroup;
  // this block's run of tiles, and the rows that start in it; the search
  // guesses assume rows of even length
  const long long ntiles = nnz > 0 ? (nnz + kTile - 1) / kTile : 1;
  const long long t0 = ntiles * blockIdx.x / gridDim.x;
  const long long t1 = ntiles * (blockIdx.x + 1) / gridDim.x;
  const double rows_per_entry = (double)m / (double)(ntiles * kTile);
  ptt::find_rows<kProbes>(indptr, m, t0 * kTile, t1 * kTile,
                          (long long)(t0 * kTile * rows_per_entry),
                          (long long)(t1 * kTile * rows_per_entry), &rows[0], &rows[1]);
  const long long r_lo = blockIdx.x == 0 ? 0 : rows[0];
  const long long r_hi = blockIdx.x + 1 == gridDim.x ? m : rows[1];   // trailing empty rows too
  const long long e_start = __ldg(indptr + r_lo), e_end = __ldg(indptr + r_hi);

  // stage of chunk j: vals window at smem + (j % kStages) kVal, col window
  // after all the vals windows
  auto vstage = [&](long long j) { return (T*)(smem + (j % kRingStages) * R::kVal); };
  auto cstage = [&](long long j) {
    return (int*)(smem + kRingStages * R::kVal + (j % kRingStages) * R::kCol);
  };
  const uint64_t stream_policy = l2_policy_evict_first();

  // thread 0 copies the next chunk into the stage of chunk j
  long long next_copy = e_start;
  auto copy_chunk = [&](long long j) {
    const long long a = next_copy, b = chunk_end(a, e_end);
    next_copy = b;
    const Window wv = window(vals, a, b), wc = window(col, a, b);
    uint64_t* bar = &full[j % kRingStages];
    mbar_expect_tx(bar, wv.bytes + wc.bytes);
    bulk_load(vstage(j), wv.src, wv.bytes, bar, stream_policy);
    bulk_load(cstage(j), wc.src, wc.bytes, bar, stream_policy);
  };
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kRingStages && next_copy < e_end; ++s) copy_chunk(s);
  }
  __syncthreads();

  // chunk j = [a, b): fetch() waits for its entries and starts the gathers
  // of x[col] into registers; finish() stores vals * x[col] in place once
  // they are back. Chunk j + 1 is fetched before chunk j is reduced.
  int ci[kPer];
  T xv[kPer];
  auto fetch = [&](long long j, long long a, long long b) {
    const int n = (int)(b - a);
    if (n > 0) mbar_wait(&full[j % kRingStages], (uint32_t)((j / kRingStages) & 1));
    const int* c = cstage(j) + window(col, a, b).off;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = tid + u * kBlockThreads;
      ci[u] = k < n ? c[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) xv[u] = tid + u * kBlockThreads < n ? __ldg(x + ci[u]) : T(0);
  };
  auto products = [&](long long j, long long a, long long b) {
    return vstage(j) + window(vals, a, b).off;
  };
  auto finish = [&](long long j, long long a, long long b) {
    const int n = (int)(b - a);
    T* v = products(j, a, b);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = tid + u * kBlockThreads;
      if (k < n) v[k] *= xv[u];
    }
    // the products are the threads' writes; the copy that next fills this
    // stage is the async proxy's, issued after a later barrier
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // row pointers a few batches ahead start to come into L2
  auto prefetch_rows = [&](long long r) {
    if (tid == 0 && r < m) {
      const long long b = r + 4 * kGroups < m ? r + 4 * kGroups : m;
      const Window w = window(indptr, r, b + 1);
      prefetch_l2(w.src, w.bytes);
    }
  };
  auto row_bounds = [&](long long r, long long& s0, long long& s1) {
    s0 = s1 = 0;
    if (r < r_hi) {
      s0 = __ldg(indptr + r);
      s1 = __ldg(indptr + r + 1);
    }
  };

  long long c0 = e_start, c1 = chunk_end(e_start, e_end), rcur = r_lo;
  fetch(0, c0, c1);
  finish(0, c0, c1);
  long long r = rcur + g, s0, s1;   // this group's row of the first batch
  row_bounds(r, s0, s1);
  __syncthreads();

  for (long long j = 0;; ++j) {
    const bool last = c1 == e_end;
    const long long d1 = last ? c1 : chunk_end(c1, e_end);   // chunk j + 1 is [c1, d1)
    if (!last) fetch(j + 1, c1, d1);
    prefetch_rows(rcur + kGroups);
    const int cs = (int)(j & 1);
    const T* pv = products(j, c0, c1);

    // rows rcur, rcur + 1, ... in batches of kGroups, one group of lanes
    // each. Chunk j + 1's products are stored before the first batch's
    // barrier, which then also makes them visible for the next reduction.
    bool first = true;
    do {
      if (!first) {
        r = rcur + g;
        row_bounds(r, s0, s1);
      }
      const bool in = r < r_hi && (s0 < c1 || last);
      T acc = T(0);
      if (in) {
        const int lo = (int)((s0 > c0 ? s0 : c0) - c0), hi = (int)((s1 < c1 ? s1 : c1) - c0);
        for (int k = lo + lane; k < hi; k += kGroup) acc += pv[k];
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, kGroup);
      const bool done = in && s1 <= c1;
      if (in && lane == 0) {
        // a row that started in an earlier chunk carries its partial sum
        if (first && g == 0 && s0 < c0) acc = carry[cs] + acc;
        if (done) y[r] = acc;
        else carry[cs ^ 1] = acc;
      }
      if (first && !last) finish(j + 1, c1, d1);
      first = false;
      const int finished = __syncthreads_count(done && lane == 0);
      rcur += finished;
      if (finished < kGroups) break;
    } while (rcur < r_hi);
    if (last) break;

    // every read of chunk j's stage is behind the last barrier: chunk
    // j + kStages may fill it
    if (tid == 0 && next_copy < e_end) copy_chunk(j);
    r = rcur + g;
    row_bounds(r, s0, s1);
    c0 = c1;
    c1 = d1;
  }
}

template <typename T>
static int launch_csr(void* y, const void* indptr, const void* col, const void* vals,
                      const void* x, long long m, long long nnz, int device, void* stream) {
  static_assert(Ring<T>::kBytes <= 227 * 1024, "the ring must fit a block's shared memory");
  PTT_TRY(cudaSetDevice(device));
  if constexpr (Ring<T>::kBytes > 48 * 1024) {
    PTT_TRY(cudaFuncSetAttribute(csr_spmv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Ring<T>::kBytes));
  }
  int sms = 0, per_sm = 0;
  PTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csr_spmv_kernel<T>, kBlockThreads,
                                                        Ring<T>::kBytes));
  const long long ntiles = nnz > 0 ? (nnz + kTile - 1) / kTile : 1;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > ntiles) grid = ntiles;
  csr_spmv_kernel<T><<<(int)grid, kBlockThreads, Ring<T>::kBytes, (cudaStream_t)stream>>>(
      (T*)y, (const long long*)indptr, (const int*)col, (const T*)vals, (const T*)x, m, nnz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_csr_spmv_f64(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, long long nnz, int device, void* stream) {
  return launch_csr<double>(y, indptr, col, vals, x, m, nnz, device, stream);
}

extern "C" int ptt_csr_spmv_f32(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, long long nnz, int device, void* stream) {
  return launch_csr<float>(y, indptr, col, vals, x, m, nnz, device, stream);
}
