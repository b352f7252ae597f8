// B1: the block-CSR (BSR) product y = A x, f64 and f32.
//
// Replaces the block-ELL product of petsc_tpu/mat/aij.py:1494-1504
// (_bind_aij_bell.mult: gather x by block column, then a batched bs x bs
// einsum, left to XLA on the TPU). The port stores the blocks as BSR: int64
// block-row pointers (mb + 1), int32 block columns, values (nblocks, bs, bs)
// row-major; the reference's padding to Kb blocks per row is ELL for the
// TPU's fixed shapes, not semantics. For block row i and component r,
//   y[i bs + r] = sum over the row's blocks k (in order) of
//                 sum over c (in order) of V[k, r, c] x[col[k] bs + c],
// each block's inner sum formed first, then added to the row's running sum
// which starts at 0. The arithmetic is rounded step by step (__dmul_rn,
// __dadd_rn: no fused multiply-add), so the plain PyTorch version, which
// takes the same steps as separate tensor operations, gives equal bits.
//
// Bound: device-memory bandwidth. Each value is read once (bs^2 per block),
// each block column once, the pointers once, x and y once: at ex56 ne 64
// (823,875 rows, 7,189,057 blocks of 3 x 3) in f64, 517.6 MB of values,
// 28.8 MB of columns, 2.2 MB of pointers and 13.2 MB of x and y, 0.168 ms at
// 3.35 TB/s, about 2 flops per 8-byte value.
//
// Design: S2's tiles (csr_spmv.cu) over the block array. A chunk is
// kChunkElems / bs blocks (kChunkElems outputs of inner sums, kPer per
// thread), fewer where that would pass kStageValues values (bs 4 and up);
// chunk edges sit at the multiples of that size whatever the grid,
// so a rerun, or a card with another SM count, gives the same bits. A
// persistent grid (the blocks that fit on the card at once) splits the
// chunks into equal contiguous runs; a thread block owns every block row
// whose first block lies in its run, found by two block-wide searches of
// indptr, and reads those rows to their ends.
// - Stream: thread 0 copies each chunk's values and block columns into a
//   ring of kStages shared-memory stages with the 1-D bulk copy
//   (cp.async.bulk, completed on an mbarrier, L2 evict-first: the matrix is
//   read once). The windows are rounded out to 16 bytes (a 3 x 3 f64 block
//   is 72 B, so a chunk's window may start mid-block) and the kernel
//   indexes from the offset.
// - Gather: while chunk j is reduced, thread t holds x[col[k] bs + c] for
//   the elements e = k bs + c (e = t, t + kThreads, ...) of chunk j + 1 in
//   registers, then stores them to shared memory (x is 6.6 MB at ne 64 and
//   stays in L2).
// - Inner sums: thread t forms s[e] = sum_c V[k, r, c] x[k, c] for e =
//   k bs + r of the chunk, from shared memory, in order over c.
// - Rows: one thread per output (block row, component) adds the row's s
//   values of the chunk in order to its running sum. A row that runs past
//   the chunk's end carries its running sum (not a partial sum) into the
//   next chunk, so every output is summed in the plain version's order.
//   Threads of a batch store consecutive y entries.
// Two block barriers per chunk (more when its rows need more batches). bs
// is a template argument for 2, 3, 4 and 6 and a run-time value for any
// other size up to 8. The constants were chosen with b1_sweep.py.
#include "common.cuh"

namespace {

constexpr int kMaxBs = 8;
constexpr int kBlockThreads = 256;                    // threads per block
constexpr int kPer = 6;                               // inner sums per thread and chunk
constexpr int kChunkElems = kPer * kBlockThreads;     // inner sums per chunk (blocks x bs)
constexpr int kStageValues = 4608;                    // values per chunk, at most (bs 3: 512 blocks)
constexpr int kStages = 2;                            // chunks in the ring
constexpr int kProbes = kBlockThreads / 2;            // probes of each of the two searches

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// The shared memory of one thread block: kStages stages of a chunk's value
// window, kStages of its column window (each with 16 bytes of slack at
// both ends for the rounding), then x of a chunk and its inner sums.
struct Layout {
  int chunk;       // blocks per chunk
  int vbytes;      // one value stage
  int cbytes;      // one column stage
  int total;
};

__host__ __device__ inline int round16(long long b) { return (int)((b + 15) / 16 * 16); }

template <typename T>
__host__ __device__ inline Layout layout(int bs) {
  Layout L;
  L.chunk = kChunkElems / bs < kStageValues / (bs * bs) ? kChunkElems / bs
                                                         : kStageValues / (bs * bs);
  L.vbytes = round16((long long)L.chunk * bs * bs * sizeof(T) + 32);
  L.cbytes = round16((long long)L.chunk * 4 + 32);
  L.total = kStages * (L.vbytes + L.cbytes) + 2 * kChunkElems * (int)sizeof(T);
  return L;
}

// BS > 0: the block size at compile time; BS == 0: bs at run time.
template <int BS, typename T>
__global__ void __launch_bounds__(kBlockThreads)
bsr_chunk_kernel(T* __restrict__ y, const long long* __restrict__ indptr,
                 const int* __restrict__ bcol, const T* __restrict__ vals,
                 const T* __restrict__ x, long long mb, long long nblocks, int bs_rt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ T carry[2][kMaxBs];
  __shared__ long long rows[2];

  const int bs = BS > 0 ? BS : bs_rt;
  const Layout L = layout<T>(bs);
  const int C = L.chunk;
  const int tid = threadIdx.x;
  const int per_batch = kBlockThreads / bs;           // block rows of one batch
  const int rq = tid / bs, comp = tid - rq * bs;      // this thread's output in a batch
  const bool out_thread = rq < per_batch;

  // this block's run of chunks, and the block rows that start in it
  const long long nchunks = nblocks > 0 ? (nblocks + C - 1) / C : 1;
  const long long t0 = nchunks * blockIdx.x / gridDim.x;
  const long long t1 = nchunks * (blockIdx.x + 1) / gridDim.x;
  const double rows_per_block = (double)mb / (double)(nchunks * C);
  ptt::find_rows<kProbes>(indptr, mb, t0 * C, t1 * C, (long long)(t0 * C * rows_per_block),
                          (long long)(t1 * C * rows_per_block), &rows[0], &rows[1]);
  const long long r_lo = blockIdx.x == 0 ? 0 : rows[0];
  const long long r_hi = blockIdx.x + 1 == gridDim.x ? mb : rows[1];   // trailing empty rows too
  const long long e_start = __ldg(indptr + r_lo), e_end = __ldg(indptr + r_hi);

  auto vstage = [&](long long j) { return (const T*)(smem + (j % kStages) * L.vbytes); };
  auto cstage = [&](long long j) {
    return (const int*)(smem + kStages * L.vbytes + (j % kStages) * L.cbytes);
  };
  T* xs = (T*)(smem + kStages * (L.vbytes + L.cbytes));   // x of the next chunk
  T* sb = xs + kChunkElems;                                // inner sums of this chunk
  const long long vper = (long long)bs * bs;
  auto chunk_end = [&](long long c0) {
    const long long b = (c0 / C + 1) * C;
    return b < e_end ? b : e_end;
  };
  const uint64_t stream_policy = ptt::l2_policy_evict_first();

  // thread 0 copies the next chunk into the stage of chunk j
  long long next_copy = e_start;
  auto copy_chunk = [&](long long j) {
    const long long a = next_copy, b = chunk_end(a);
    next_copy = b;
    const ptt::Window wv = ptt::window(vals, a * vper, b * vper), wc = ptt::window(bcol, a, b);
    uint64_t* bar = &full[j % kStages];
    ptt::mbar_expect_tx(bar, wv.bytes + wc.bytes);
    ptt::bulk_load((void*)vstage(j), wv.src, wv.bytes, bar, stream_policy);
    ptt::bulk_load((void*)cstage(j), wc.src, wc.bytes, bar, stream_policy);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) ptt::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && next_copy < e_end; ++s) copy_chunk(s);
  }
  __syncthreads();

  // chunk j = blocks [a, b): fetch() waits for its columns and starts the
  // gathers of x into registers; put_x() stores them once they are back
  T xv[kPer];
  auto fetch = [&](long long j, long long a, long long b) {
    const int n = (int)(b - a) * bs;
    if (n > 0) ptt::mbar_wait(&full[j % kStages], (uint32_t)((j / kStages) & 1));
    const int* c = cstage(j) + ptt::window(bcol, a, b).off;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kBlockThreads;
      const int k = e / bs;
      xv[u] = e < n ? __ldg(x + (long long)c[k] * bs + (e - k * bs)) : T(0);
    }
  };
  auto put_x = [&](long long a, long long b) {
    const int n = (int)(b - a) * bs;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kBlockThreads;
      if (e < n) xs[e] = xv[u];
    }
  };
  // the inner sums of chunk j, in order over c, each step rounded
  auto inner = [&](long long j, long long a, long long b) {
    const int n = (int)(b - a) * bs;
    const T* v = vstage(j) + ptt::window(vals, a * vper, b * vper).off;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kBlockThreads;
      if (e < n) {
        const int k = e / bs;
        const T* vr = v + (long long)e * bs;     // V[k, r, :] at (k bs + r) bs
        const T* xk = xs + k * bs;
        T s = mul_rn(vr[0], xk[0]);
        if constexpr (BS > 0) {
#pragma unroll
          for (int c = 1; c < BS; ++c) s = add_rn(s, mul_rn(vr[c], xk[c]));
        } else {
          for (int c = 1; c < bs; ++c) s = add_rn(s, mul_rn(vr[c], xk[c]));
        }
        sb[e] = s;
      }
    }
  };
  // row pointers a few batches ahead start to come into L2
  auto prefetch_rows = [&](long long r) {
    if (tid == 0 && r < mb) {
      const long long b = r + 4 * per_batch < mb ? r + 4 * per_batch : mb;
      const ptt::Window w = ptt::window(indptr, r, b + 1);
      ptt::prefetch_l2(w.src, w.bytes);
    }
  };
  auto row_bounds = [&](long long r, long long& s0, long long& s1) {
    s0 = s1 = 0;
    if (out_thread && r < r_hi) {
      s0 = __ldg(indptr + r);
      s1 = __ldg(indptr + r + 1);
    }
  };

  long long c0 = e_start, c1 = chunk_end(e_start), rcur = r_lo;
  fetch(0, c0, c1);
  put_x(c0, c1);
  long long r = rcur + rq, s0, s1;   // this thread's block row of the first batch
  row_bounds(r, s0, s1);
  __syncthreads();

  for (long long j = 0;; ++j) {
    const bool last = c1 == e_end;
    const long long d1 = last ? c1 : chunk_end(c1);   // chunk j + 1 is [c1, d1)
    if (!last) fetch(j + 1, c1, d1);
    prefetch_rows(rcur + per_batch);
    inner(j, c0, c1);
    const int cs = (int)(j & 1);
    // the inner sums are visible, and every read of chunk j's stage is
    // behind this barrier: chunk j + kStages may fill it
    __syncthreads();
    if (tid == 0 && next_copy < e_end) copy_chunk(j);

    // block rows rcur, rcur + 1, ... in batches of per_batch, bs threads
    // each. Chunk j + 1's x is stored before the first batch's barrier,
    // which then makes it visible for the next chunk's inner sums.
    bool first = true;
    do {
      if (!first) {
        r = rcur + rq;
        row_bounds(r, s0, s1);
      }
      const bool in = out_thread && r < r_hi && (s0 < c1 || last);
      const bool done = in && s1 <= c1;
      if (in) {
        // a row that started in an earlier chunk goes on from its running sum
        T acc = (first && rq == 0 && s0 < c0) ? carry[cs][comp] : T(0);
        const int lo = (int)((s0 > c0 ? s0 : c0) - c0), hi = (int)((s1 < c1 ? s1 : c1) - c0);
        for (int k = lo; k < hi; ++k) acc = add_rn(acc, sb[k * bs + comp]);
        if (done) y[r * bs + comp] = acc;
        else carry[cs ^ 1][comp] = acc;
      }
      if (first && !last) put_x(c1, d1);
      first = false;
      const int finished = __syncthreads_count(done && comp == 0);
      rcur += finished;
      if (finished < per_batch) break;
    } while (rcur < r_hi);
    if (last) break;
    r = rcur + rq;
    row_bounds(r, s0, s1);
    c0 = c1;
    c1 = d1;
  }
}

template <int BS, typename T>
int launch_bs(T* y, const long long* indptr, const int* bcol, const T* vals, const T* x,
              long long mb, long long nblocks, int bs, int device, cudaStream_t stream,
              int* cfg) {
  const Layout L = layout<T>(bs);
  if (L.total > 227 * 1024) return (int)cudaErrorInvalidValue;   // bs 3 f64 takes 102 KB
  auto kernel = bsr_chunk_kernel<BS, T>;
  if (L.total > 48 * 1024)
    PTT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total));
  int sms = 0, per_sm = 0;
  PTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, L.total));
  const long long nchunks = nblocks > 0 ? (nblocks + L.chunk - 1) / L.chunk : 1;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > nchunks) grid = nchunks;
  if (cfg) {   // the launch a call would make, without launching
    cfg[0] = (int)grid;
    cfg[1] = kBlockThreads;
    cfg[2] = L.chunk;
    cfg[3] = kStages;
    cfg[4] = L.total;
    cfg[5] = per_sm;
    cfg[6] = sms;
    return 0;
  }
  kernel<<<(int)grid, kBlockThreads, L.total, stream>>>(y, indptr, bcol, vals, x, mb, nblocks,
                                                        bs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bsr(void* y, const void* indptr, const void* bcol, const void* vals, const void* x,
               long long mb, long long nblocks, int bs, int device, void* stream, int* cfg) {
  PTT_TRY(cudaSetDevice(device));
  if (bs < 1 || bs > kMaxBs) return (int)cudaErrorInvalidValue;
  if (mb == 0 && !cfg) return (int)cudaSuccess;
  auto* yy = (T*)y;
  auto* ip = (const long long*)indptr;
  auto* bc = (const int*)bcol;
  auto* vv = (const T*)vals;
  auto* xx = (const T*)x;
  auto s = (cudaStream_t)stream;
  switch (bs) {
    case 2: return launch_bs<2, T>(yy, ip, bc, vv, xx, mb, nblocks, bs, device, s, cfg);
    case 3: return launch_bs<3, T>(yy, ip, bc, vv, xx, mb, nblocks, bs, device, s, cfg);
    case 4: return launch_bs<4, T>(yy, ip, bc, vv, xx, mb, nblocks, bs, device, s, cfg);
    case 6: return launch_bs<6, T>(yy, ip, bc, vv, xx, mb, nblocks, bs, device, s, cfg);
    default: return launch_bs<0, T>(yy, ip, bc, vv, xx, mb, nblocks, bs, device, s, cfg);
  }
}

}  // namespace

extern "C" int ptt_bsr_spmv_f64(void* y, const void* indptr, const void* bcol, const void* vals,
                                const void* x, long long mb, long long nblocks, int bs, int device,
                                void* stream) {
  return launch_bsr<double>(y, indptr, bcol, vals, x, mb, nblocks, bs, device, stream, nullptr);
}

extern "C" int ptt_bsr_spmv_f32(void* y, const void* indptr, const void* bcol, const void* vals,
                                const void* x, long long mb, long long nblocks, int bs, int device,
                                void* stream) {
  return launch_bsr<float>(y, indptr, bcol, vals, x, mb, nblocks, bs, device, stream, nullptr);
}

// The launch of B1 for nblocks blocks of bs x bs (itemsize 8 or 4) on
// `device`, without launching: cfg[0..6] = blocks, threads, blocks per
// chunk, stages, shared bytes per block, blocks per SM, SMs.
extern "C" int ptt_bsr_spmv_config(long long nblocks, int bs, int itemsize, int device,
                                   int* cfg) {
  return itemsize == 8
             ? launch_bsr<double>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, nblocks, bs,
                                  device, nullptr, cfg)
             : launch_bsr<float>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, nblocks, bs,
                                 device, nullptr, cfg);
}
