// M1: CSR times a row-major block of vectors,
//   Y[i, c] = sum_{p in [indptr[i], indptr[i+1])} vals[p] * X[col[p], c],
// f64 and f32, for X of shape (n, ld) row-major and a tile of kt <= 8 of
// its columns per launch.
//
// Replaces no Pallas kernel: the reference applies a sparse operator to
// every component of a node-major block as one jax.vmap of the CSR product
// (petsc_tpu/mat/utility.py:356-372, MatMAIJ) or as a stack of p products
// (petsc_tpu/mat/extra_formats.py:59-70, MatKAIJ); ops/spmv.py:40 ell_spmm
// has the same semantics. Run as k launches of S2 it would read the matrix
// k times; here it is read once for all k columns.
//
// Bound: nnz * (itemsize + 4) + (m + 1) * 8 + (n + m) * k * itemsize bytes
// (vals and col streamed once, indptr read once, X read once, Y written
// once) over 3.35 TB/s, for 2 nnz k flops: device-memory bandwidth. On the
// 128^3 box27 CSR at k = 3 in f64 that is 0.235 ms.
//
// Design: S2's entry tiles (csr_spmv.cu). A persistent grid of 512-thread
// blocks (two per SM) splits the chunks of entries into equal contiguous
// runs; a block owns every row whose
// first entry lies in its run (two block-wide searches over indptr) and
// reads those rows to their ends. Thread 0 copies each chunk's vals and
// col into a ring of shared-memory stages (cp.async.bulk on an mbarrier,
// L2 evict-first, 16-byte aligned windows, so slices at any element are
// taken as they are). Rows are taken in batches, a group of lanes per
// (row, pair of columns); a row that runs past a chunk carries its partial
// sums to the next chunk. Chunk edges sit at multiples of the chunk size,
// which depends on the type alone, so a rerun, or a card with another SM
// count, gives the same bits.
// - A row's groups gather X themselves from the staged col and vals. A
//   pair is the W adjacent columns that one load reads (16-byte loads of
//   two doubles or four floats where k * itemsize is a multiple of 16 and
//   X's rows are 16-byte aligned, 8-byte loads of two floats, else one
//   value); a row has one lane per pair at three or more pairs, else
//   kRowLanes / pairs (4 in f64, 2 in f32). A lane loads the columns,
//   values and X of kBatchK of its entries, then adds their products in
//   order (fma_rn: the compiler's contractions cannot change the bits); a
//   fixed shuffle tree joins a pair's lanes. Neighbouring rows of a
//   stencil name neighbouring rows of X, so the lanes of one column in a
//   warp read X in runs of adjacent rows, and each row's k results are
//   stored to adjacent addresses. No product buffer: the ring alone is the
//   shared memory, which leaves L1 room for X.
// - One column of a one-column X is S2's product: launch_csr_spmm calls
//   S2's entry point (csr_spmv.cu, linked into the same library), which
//   gathers x[col] a chunk ahead into a product buffer. The last tile of a
//   wider X, one column of rows ld long, takes the lanes above.
// The chunk is 16 KB of values (2048 doubles, 4096 floats), in a ring of
// three stages in f64 and two in f32, chosen with m1_probe.py on the 128^3
// box27 CSR. indptr is int64 (rows of any length); col is int32, so X holds
// fewer than 2^31 rows.
#include "common.cuh"

extern "C" int ptt_csr_spmv_f64(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, long long nnz, int device, void* stream);
extern "C" int ptt_csr_spmv_f32(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, long long nnz, int device, void* stream);

namespace {

constexpr int kMaxTile = 8;       // columns per launch; the wrapper tiles a wider X
constexpr int kThreads = 512;     // threads per block
constexpr int kBlocks64 = 2;      // blocks of the persistent grid on one SM, f64
constexpr int kBlocks32 = 2;      // and f32
constexpr int kChunkBytes = 16384;   // values per chunk, in bytes
constexpr int kStages64 = 3;      // chunks in the ring, f64
constexpr int kStages32 = 2;      // and f32
constexpr int kRowLanes64 = 4;    // lanes that take one row (at least one per pair), f64
constexpr int kRowLanes32 = 2;    // and f32
constexpr int kBatchK = 4;        // entries a lane loads before it adds them

using ptt::bulk_load;
using ptt::l2_policy_evict_first;
using ptt::mbar_expect_tx;
using ptt::mbar_init;
using ptt::mbar_wait;
using ptt::prefetch_l2;
using ptt::window;
using ptt::Window;

// W adjacent values of X from an address aligned to all W (W > 1) or one value
template <typename T, int W>
__device__ __forceinline__ void load_x(T (&v)[W], const T* p) {
  if constexpr (W == 1) {
    v[0] = __ldg(p);
  } else if constexpr (W == 2 && sizeof(T) == 8) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  } else if constexpr (W == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    static_assert(W == 4, "16 bytes are two doubles or four floats");
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// The shape of the kernel for values T, K columns and W values per load.
template <typename T, int K, int W>
struct Plan {
  static constexpr int kChunk = kChunkBytes / (int)sizeof(T);       // entries
  static constexpr int kStages = sizeof(T) == 8 ? kStages64 : kStages32;
  static constexpr int kPairs = K / W;                               // pairs per row
  static constexpr int kRowLanes = sizeof(T) == 8 ? kRowLanes64 : kRowLanes32;
  static constexpr int kGroup = kPairs < kRowLanes ? kRowLanes / kPairs : 1;   // lanes per pair
  static constexpr int kBlocksPerSM = sizeof(T) == 8 ? kBlocks64 : kBlocks32;
  static constexpr int kRows = kThreads / kGroup / kPairs;           // rows per batch
  static constexpr int kVal = kChunk * (int)sizeof(T) + 32;          // a stage's vals window
  static constexpr int kCol = kChunk * 4 + 32;                       // and its col window
  static constexpr int kBytes = kStages * (kVal + kCol);
  static_assert(K % W == 0, "a row of the tile is whole loads");
};

// The end of the chunk that starts at entry c0: the next multiple of the
// chunk size, or the block's last entry.
template <int kChunk>
__device__ __forceinline__ long long chunk_end(long long c0, long long e_end) {
  const long long b = (c0 / kChunk + 1) * kChunk;
  return b < e_end ? b : e_end;
}

template <typename T, int K, int W>
__global__ void __launch_bounds__(kThreads, Plan<T, K, W>::kBlocksPerSM)
csr_spmm_kernel(T* __restrict__ y, const long long* __restrict__ indptr,
                const int* __restrict__ col, const T* __restrict__ vals,
                const T* __restrict__ x, long long m, long long nnz, int ld) {
  using P = Plan<T, K, W>;
  constexpr int kChunk = P::kChunk, kGroup = P::kGroup, kStages = P::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ T carry[2][K];
  __shared__ long long rows[2];

  const int tid = threadIdx.x, lane = tid % kGroup, g = tid / kGroup;
  const int ri = g / P::kPairs, c = g % P::kPairs;   // this group's row in a batch and pair
  // this block's run of chunks, and the rows that start in it; the search
  // guesses assume rows of even length
  const long long nchunks = nnz > 0 ? (nnz + kChunk - 1) / kChunk : 1;
  const long long t0 = nchunks * blockIdx.x / gridDim.x;
  const long long t1 = nchunks * (blockIdx.x + 1) / gridDim.x;
  const double rows_per_entry = (double)m / (double)(nchunks * kChunk);
  ptt::find_rows<kThreads / 2>(indptr, m, t0 * kChunk, t1 * kChunk,
                               (long long)(t0 * kChunk * rows_per_entry),
                               (long long)(t1 * kChunk * rows_per_entry), &rows[0], &rows[1]);
  const long long r_lo = blockIdx.x == 0 ? 0 : rows[0];
  const long long r_hi = blockIdx.x + 1 == gridDim.x ? m : rows[1];   // trailing empty rows too
  const long long e_start = __ldg(indptr + r_lo), e_end = __ldg(indptr + r_hi);

  // stage of chunk j: vals window at smem + (j % kStages) kVal, col window
  // after all the vals windows
  auto vstage = [&](long long j) { return (T*)(smem + (j % kStages) * P::kVal); };
  auto cstage = [&](long long j) {
    return (int*)(smem + kStages * P::kVal + (j % kStages) * P::kCol);
  };
  const uint64_t stream_policy = l2_policy_evict_first();

  // thread 0 copies the next chunk into the stage of chunk j
  long long next_copy = e_start;
  auto copy_chunk = [&](long long j) {
    const long long a = next_copy, b = chunk_end<kChunk>(a, e_end);
    next_copy = b;
    const Window wv = window(vals, a, b), wc = window(col, a, b);
    uint64_t* bar = &full[j % kStages];
    mbar_expect_tx(bar, wv.bytes + wc.bytes);
    bulk_load(vstage(j), wv.src, wv.bytes, bar, stream_policy);
    bulk_load(cstage(j), wc.src, wc.bytes, bar, stream_policy);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && next_copy < e_end; ++s) copy_chunk(s);
  }
  __syncthreads();
  auto wait_chunk = [&](long long j, long long a, long long b) {
    if (b > a) mbar_wait(&full[j % kStages], (uint32_t)((j / kStages) & 1));
  };

  // This lane's sums over its entries lo + lane, lo + lane + kGroup, ...
  // (chunk-relative, below hi) of the chunk whose values are v and columns
  // cs, in order: the products with X[col, c W .. c W + W), gathered
  // kBatchK entries at a time.
  auto lane_sums = [&](const T* v, const int* cs, int lo, int hi, T (&acc)[W]) {
    for (int e = lo + lane; e < hi; e += kBatchK * kGroup) {
      int cb[kBatchK];
      T vb[kBatchK], xb[kBatchK][W];
#pragma unroll
      for (int b = 0; b < kBatchK; ++b) {
        const int eb = e + b * kGroup;
        cb[b] = eb < hi ? cs[eb] : -1;
        vb[b] = eb < hi ? v[eb] : T(0);
      }
#pragma unroll
      for (int b = 0; b < kBatchK; ++b)
        if (cb[b] >= 0) load_x<T, W>(xb[b], x + (long long)cb[b] * ld + c * W);
#pragma unroll
      for (int b = 0; b < kBatchK; ++b) {
        if (cb[b] >= 0) {
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] = ptt::fma_rn(vb[b], xb[b][w], acc[w]);
        }
      }
    }
  };
  // row pointers a few batches ahead start to come into L2
  auto prefetch_rows = [&](long long r) {
    if (tid == 0 && r < m) {
      const long long b = r + 4 * P::kRows < m ? r + 4 * P::kRows : m;
      const Window w = window(indptr, r, b + 1);
      prefetch_l2(w.src, w.bytes);
    }
  };
  auto row_bounds = [&](long long r, long long& s0, long long& s1) {
    s0 = s1 = 0;
    if (ri < P::kRows && r < r_hi) {
      s0 = __ldg(indptr + r);
      s1 = __ldg(indptr + r + 1);
    }
  };

  long long c0 = e_start, c1 = chunk_end<kChunk>(e_start, e_end), rcur = r_lo;
  long long r = rcur + ri, s0, s1;   // this group's row of the first batch
  row_bounds(r, s0, s1);
  __syncthreads();

  for (long long j = 0;; ++j) {
    const bool last = c1 == e_end;
    const long long d1 = last ? c1 : chunk_end<kChunk>(c1, e_end);   // chunk j + 1 is [c1, d1)
    wait_chunk(j, c0, c1);
    prefetch_rows(rcur + P::kRows);
    const int cs = (int)(j & 1);
    const T* pv = vstage(j) + window(vals, c0, c1).off;   // chunk j's values
    const int* pc = cstage(j) + window(col, c0, c1).off;  // and columns

    // rows rcur, rcur + 1, ... in batches of kRows, one group of lanes per
    // (row, pair)
    bool first = true;
    do {
      if (!first) {
        r = rcur + ri;
        row_bounds(r, s0, s1);
      }
      const bool in = ri < P::kRows && r < r_hi && (s0 < c1 || last);
      T acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = T(0);
      if (in) {
        const int lo = (int)((s0 > c0 ? s0 : c0) - c0), hi = (int)((s1 < c1 ? s1 : c1) - c0);
        lane_sums(pv, pc, lo, hi, acc);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] += __shfl_down_sync(0xffffffffu, acc[w], off, kGroup);
      }
      const bool done = in && s1 <= c1;
      if (in && lane == 0) {
        // a row that started in an earlier chunk carries its partial sums
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (first && ri == 0 && s0 < c0) acc[w] = carry[cs][c * W + w] + acc[w];
          if (done) y[r * ld + c * W + w] = acc[w];
          else carry[cs ^ 1][c * W + w] = acc[w];
        }
      }
      first = false;
      const int finished = __syncthreads_count(done && lane == 0 && c == 0);
      rcur += finished;
      if (finished < P::kRows) break;
    } while (rcur < r_hi);
    if (last) break;

    // every read of chunk j's stage is behind the last barrier: chunk
    // j + kStages may fill it
    if (tid == 0 && next_copy < e_end) copy_chunk(j);
    r = rcur + ri;
    row_bounds(r, s0, s1);
    c0 = c1;
    c1 = d1;
  }
}

template <typename T, int K, int W>
static int launch_tile(T* y, const long long* indptr, const int* col, const T* vals, const T* x,
                       long long m, long long nnz, int ld, int device, cudaStream_t stream) {
  using P = Plan<T, K, W>;
  static_assert(P::kBytes <= 227 * 1024, "the ring must fit a block's shared memory");
  auto kernel = csr_spmm_kernel<T, K, W>;
  if constexpr (P::kBytes > 48 * 1024) {
    PTT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes));
  }
  constexpr int kB = P::kBlocksPerSM;
  int sms = 0, per_sm = 0;
  PTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, P::kBytes));
  const long long nchunks = nnz > 0 ? (nnz + P::kChunk - 1) / P::kChunk : 1;
  long long grid = (long long)sms * (per_sm < 1 ? 1 : per_sm < kB ? per_sm : kB);
  if (grid > nchunks) grid = nchunks;
  kernel<<<(int)grid, kThreads, P::kBytes, stream>>>(y, indptr, col, vals, x, m, nnz, ld);
  return (int)cudaGetLastError();
}

// K columns; 16-byte loads where a row of the tile is whole 16-byte words
// and every row of X starts on a 16-byte edge, else 8-byte loads of two
// floats where it is whole 8-byte words on 8-byte edges, else one value
template <typename T, int K>
static int launch_k(T* y, const long long* indptr, const int* col, const T* vals, const T* x,
                    long long m, long long nnz, int ld, int device, cudaStream_t stream) {
  constexpr int kW = 16 / (int)sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  if constexpr (K % kW == 0) {
    if (at % 16 == 0 && (ld * (int)sizeof(T)) % 16 == 0)
      return launch_tile<T, K, kW>(y, indptr, col, vals, x, m, nnz, ld, device, stream);
  }
  if constexpr (sizeof(T) == 4 && K % 2 == 0) {
    if (at % 8 == 0 && ld % 2 == 0)
      return launch_tile<T, K, 2>(y, indptr, col, vals, x, m, nnz, ld, device, stream);
  }
  return launch_tile<T, K, 1>(y, indptr, col, vals, x, m, nnz, ld, device, stream);
}

// y, x: the tile's first column (the caller adds the column offset); ld:
// the full row length of X and Y; kt: the tile's columns, 1..8.
template <typename T>
static int launch_csr_spmm(void* y, const void* indptr, const void* col, const void* vals,
                           const void* x, long long m, long long nnz, int ld, int kt, int device,
                           void* stream) {
  if (kt == 1 && ld == 1)   // S2's product
    return sizeof(T) == 8 ? ptt_csr_spmv_f64(y, indptr, col, vals, x, m, nnz, device, stream)
                          : ptt_csr_spmv_f32(y, indptr, col, vals, x, m, nnz, device, stream);
  PTT_TRY(cudaSetDevice(device));
  T* yo = (T*)y;
  const long long* ip = (const long long*)indptr;
  const int* cl = (const int*)col;
  const T* v = (const T*)vals;
  const T* xi = (const T*)x;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kt) {
    case 1: return launch_k<T, 1>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    case 2: return launch_k<T, 2>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    case 3: return launch_k<T, 3>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    case 4: return launch_k<T, 4>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    case 5: return launch_k<T, 5>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    case 6: return launch_k<T, 6>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    case 7: return launch_k<T, 7>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    case 8: return launch_k<T, kMaxTile>(yo, ip, cl, v, xi, m, nnz, ld, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ptt_csr_spmm_f64(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, long long nnz, int ld, int kt,
                                int device, void* stream) {
  return launch_csr_spmm<double>(y, indptr, col, vals, x, m, nnz, ld, kt, device, stream);
}

extern "C" int ptt_csr_spmm_f32(void* y, const void* indptr, const void* col, const void* vals,
                                const void* x, long long m, long long nnz, int ld, int kt,
                                int device, void* stream) {
  return launch_csr_spmm<float>(y, indptr, col, vals, x, m, nnz, ld, kt, device, stream);
}
