// T1: the level-scheduled sparse triangular sweep, one launch per sweep.
//
// Replaces petsc_tpu/ops/trisolve.py:94-119 trisolve_apply and the sweeps
// of unit_lower_solve (:122), unit_upper_solve (:138) and
// trisolve_transpose_apply (:186): each a lax.fori_loop over the
// dependency levels of a triangular factor, one vectorised gather and
// scatter per level (not Pallas; XLA ran it). One sweep computes, level by
// level (l = 0, 1, ...), for every row r of level l
//
//   x[r] = (b[r] - sum_k a[r,k] x[col[r,k]]) * (scale ? scale[r] : 1)
//
// where the columns of a row lie in earlier levels. ILU's forward sweep
// (unit L), its backward sweep (U, scale = dinv), the transpose's two and
// SOR's unit sweeps differ only in their level tables and factors.
//
// Bound: each factor entry, index, row pointer and vector entry is read
// once and x written once, so the bytes over 3.35 TB/s give a few
// microseconds; but a level can start only after the level before it has
// been written, so the dependency depth (498 levels per sweep for the
// 7-point stencil on 22 x 239 x 239 in natural order) times the latency
// of one level sets the time, far above that bound. The design shortens
// what stands between one level and the next:
// - Two variants, one launch per sweep each, no level loop on the host.
//   The plan (ops/trisolve.py sweep_plan) picks one per sweep from its
//   widest level:
//   * cluster: one thread-block cluster of up to 16 blocks of up to 512
//     threads (cudaLaunchKernelEx with a cluster dimension; above 8
//     blocks the non-portable size is allowed), one row of the widest
//     level per thread, spread over as many blocks as the cluster
//     allows, and the cluster's hardware barrier between levels. A
//     cluster that the card cannot place (cudaOccupancyMaxActiveClusters
//     < 1) is refused by the wrapper.
//   * grid: a sweep wider than a cluster holds (one-level diagonals of
//     300,001 rows) takes one cooperative launch of 256-thread blocks,
//     as many as give each row of the widest level its own thread, at
//     most what the card holds at once, with a grid barrier between
//     levels (atomics on two counters that the wrapper owns per stream).
// - Each barrier is split into its arrive and its wait, and between the
//   two each thread issues the loads, into registers, of its row of level
//   l + 2 (b[r], the scale, its first kDepth entries' columns and values)
//   and of the row and row pointers of its row of level l + 3. A release
//   orders the loads before it, so loads issued before an arrive would be
//   waited for there; issued after it, they have a level to land. After
//   the wait only the loads of x and the sum stand between one level and
//   the next. A row longer than kDepth loads the rest after the barrier,
//   in column order. A thread's further rows of a level (the grid
//   variant's wide levels) load everything after the barrier. No load
//   issued ahead reads x.
// - x in level order: the kernel keeps x at each row's position in level
//   order (xl, scratch from the wrapper) and the columns as positions
//   (pcols), so that a level's neighbouring rows, whose columns lie on
//   neighbouring rows of an earlier level, read and write neighbouring
//   words of xl rather than one 32-byte sector each; x itself is also
//   stored at each row (read by no later level).
// - The rows are stored in level order with their entries contiguous
//   (CSR in level order, int32), so a level's threads read neighbouring
//   row pointers, columns and values; the row's scale is stored in level
//   order too.
// - Visibility: a row reads xl written by other blocks (other SMs) in
//   earlier levels. xl is stored with __stcg and read with __ldcg, at L2,
//   past the SM's L1, which may hold a stale line; xl is not __restrict__,
//   so no read of it moves across a barrier. Cluster: the block's threads
//   meet (__syncthreads), warp 0 arrives with release semantics at
//   cluster scope (cumulative over the block's stores), the other warps
//   arrive relaxed, and every thread's wait acquires; a release by every
//   warp costs more for the same order. Grid: the same meeting, then
//   thread 0 fences before its arrival and its wait loads the generation
//   with acquire semantics.
// - Equal bits with the plain version: each product and sum is rounded
//   on its own (no fused multiply-add), a row's entries summed in column
//   order from 0, then b minus the sum, then the scale, in the type that
//   the factor and vector types promote to (double unless both are
//   float), and the result rounded to the vector's type.
#include "common.cuh"

namespace {

constexpr int kGridThreads = 256;       // threads of a grid-variant block
constexpr int kClusterThreads = 512;    // threads of a cluster-variant block at most
constexpr int kMaxCluster = 16;         // blocks of a cluster at most (non-portable above 8)
constexpr int kDepth = 4;               // entries of a row loaded before its level

template <typename A> __device__ __forceinline__ A mul_rn(A a, A b);
template <typename A> __device__ __forceinline__ A add_rn(A a, A b);
template <typename A> __device__ __forceinline__ A sub_rn(A a, A b);
template <> __device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
template <> __device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
template <> __device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
template <> __device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
template <> __device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
template <> __device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

template <typename V, typename F>
struct Acc {
  using type = double;
};
template <>
struct Acc<float, float> {
  using type = float;
};

// The grid barrier in two halves, so that loads can be issued between
// them without a fence waiting for them. bar[0] counts arrivals (back to
// 0 when the last one arrives), bar[1] is the generation that the last
// arrival advances. grid_arrive returns the generation it arrived in
// (thread 0 only); grid_wait(bar, g) returns once it has moved on.
__device__ __forceinline__ unsigned int grid_arrive(unsigned int* bar) {
  __syncthreads();
  unsigned int g = 0;
  if (threadIdx.x == 0) {
    g = *(volatile unsigned int*)(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    }
  }
  return g;
}

__device__ __forceinline__ void grid_wait(unsigned int* bar, unsigned int g) {
  if (threadIdx.x == 0) {
    unsigned int now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(bar + 1) : "memory");
    } while (now == g);
  }
  __syncthreads();
}

// The cluster's hardware barrier in two halves: the stores before
// cluster_arrive are visible across the cluster to the loads after
// cluster_wait. The block's threads meet first (__syncthreads orders
// their stores before warp 0's arrive), and only warp 0 arrives with
// release semantics, which are cumulative; the other warps arrive
// relaxed. Loads issued between the halves are waited for by neither.
__device__ __forceinline__ void cluster_arrive() {
  __syncthreads();
  if (threadIdx.x < 32)
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A thread's row of one level: its position p in level order (-1: the
// thread has no row there), the factor's row and its entries [e0, e1).
struct Meta {
  int p, row, e0, e1;
};

// The level [p0, p1)'s row of thread `tid`.
__device__ __forceinline__ Meta load_meta(int p0, int p1, int tid, const int* __restrict__ rows,
                                          const int* __restrict__ rp) {
  Meta m{-1, 0, 0, 0};
  const int p = p0 + tid;
  if (p < p1) {
    m.p = p;
    m.row = __ldg(rows + p);
    m.e0 = __ldg(rp + p);
    m.e1 = __ldg(rp + p + 1);
  }
  return m;
}

// A row's operands that do not depend on x: b[row], the scale and the
// first kDepth entries' columns (as level-order positions) and values
// (unused slots hold 0, never read).
template <typename V, typename F>
struct Ops {
  Meta m;
  int col[kDepth];
  F val[kDepth];
  V bv;
  F sc;
};

template <typename V, typename F>
__device__ __forceinline__ void load_ops(const Meta& m, Ops<V, F>& o, const V* __restrict__ b,
                                         const int* __restrict__ pcols,
                                         const F* __restrict__ vals,
                                         const F* __restrict__ scale) {
  o.m = m;
  o.bv = V(0);
  o.sc = F(1);
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    o.col[k] = 0;
    o.val[k] = F(0);
  }
  if (m.p < 0) return;
  o.bv = __ldg(b + m.row);
  if (scale) o.sc = __ldg(scale + m.p);
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    if (m.e0 + k < m.e1) {
      o.col[k] = __ldg(pcols + m.e0 + k);
      o.val[k] = __ldg(vals + m.e0 + k);
    }
  }
}

// x of a row whose operands were loaded ahead, stored at its position in
// xl (x in level order, which later rows read: neighbouring rows of a
// level read and write neighbouring positions); xv holds xl of its first
// kDepth columns, loaded after the barrier. Returns the value for x[row].
template <typename A, typename V, typename F>
__device__ __forceinline__ V finish_row(V* xl, const Ops<V, F>& o, const V (&xv)[kDepth],
                                        const int* __restrict__ pcols,
                                        const F* __restrict__ vals, bool scaled) {
  const int n = o.m.e1 - o.m.e0;
  A s = A(0);
#pragma unroll
  for (int k = 0; k < kDepth; ++k)
    if (k < n) s = add_rn(s, mul_rn((A)o.val[k], (A)xv[k]));
  for (int e = o.m.e0 + kDepth; e < o.m.e1; ++e)
    s = add_rn(s, mul_rn((A)__ldg(vals + e), (A)__ldcg(xl + __ldg(pcols + e))));
  A v = sub_rn((A)o.bv, s);
  if (scaled) v = mul_rn(v, (A)o.sc);
  __stcg(xl + o.m.p, (V)v);
  return (V)v;
}

// A row with nothing loaded ahead (a thread's second and later rows of a
// level wider than the grid), stored in xl and x.
template <typename A, typename V, typename F>
__device__ __forceinline__ void solve_row(V* x, V* xl, int p, const V* __restrict__ b,
                                          const int* __restrict__ rows,
                                          const int* __restrict__ rp,
                                          const int* __restrict__ pcols,
                                          const F* __restrict__ vals,
                                          const F* __restrict__ scale) {
  const int r = __ldg(rows + p);
  const int e1 = __ldg(rp + p + 1);
  A s = A(0);
  for (int e = __ldg(rp + p); e < e1; ++e)
    s = add_rn(s, mul_rn((A)__ldg(vals + e), (A)__ldcg(xl + __ldg(pcols + e))));
  A v = sub_rn((A)__ldg(b + r), s);
  if (scale) v = mul_rn(v, (A)__ldg(scale + p));
  __stcg(xl + p, (V)v);
  x[r] = (V)v;
}

// The sweep. kCluster: the grid is one cluster and levels are separated
// by the cluster barrier; else a cooperative grid and the grid barrier.
// Level l runs its first rows' loads of xl and sums (operands loaded two
// levels before), stores them in xl and x, runs its further rows,
// arrives at the barrier, then issues the loads of level l + 2's operands
// and of level l + 3's rows, and waits. lp_k holds lev_ptr[l + k]
// (clamped to lev_ptr[nlev]: empty levels past the last).
template <typename V, typename F, bool kCluster>
__global__ void __launch_bounds__(kCluster ? kClusterThreads : kGridThreads, 1)
trisolve_kernel(V* x, V* xl, const V* __restrict__ b, const int* __restrict__ lev_ptr, int nlev,
                const int* __restrict__ rows, const int* __restrict__ rp,
                const int* __restrict__ pcols, const F* __restrict__ vals,
                const F* __restrict__ scale, unsigned int* bar) {
  using A = typename Acc<V, F>::type;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool scaled = scale != nullptr;
  auto lev = [&](int k) { return __ldg(lev_ptr + (k < nlev ? k : nlev)); };
  int lp0 = lev(0), lp1 = lev(1), lp2 = lev(2), lp3 = lev(3), lp4 = lev(4);
  Ops<V, F> cur, nxt;
  load_ops(load_meta(lp0, lp1, tid, rows, rp), cur, b, pcols, vals, scale);
  load_ops(load_meta(lp1, lp2, tid, rows, rp), nxt, b, pcols, vals, scale);
  Meta ahead = load_meta(lp2, lp3, tid, rows, rp);
  for (int l = 0; l < nlev; ++l) {
    // level l: xl of the first row's loaded columns (after the barrier)
    V xv[kDepth];
    const int n = cur.m.e1 - cur.m.e0;
#pragma unroll
    for (int k = 0; k < kDepth; ++k)
      xv[k] = (cur.m.p >= 0 && k < n) ? __ldcg(xl + cur.col[k]) : V(0);
    if (cur.m.p >= 0) x[cur.m.row] = finish_row<A>(xl, cur, xv, pcols, vals, scaled);
    for (int p = lp0 + tid + stride; p < lp1; p += stride)
      solve_row<A>(x, xl, p, b, rows, rp, pcols, vals, scale);
    if (l + 1 == nlev) break;
    unsigned int g = 0;
    if (kCluster)
      cluster_arrive();
    else
      g = grid_arrive(bar);
    // between the halves: level l + 2's operands, level l + 3's rows
    Ops<V, F> far;
    load_ops(ahead, far, b, pcols, vals, scale);
    ahead = load_meta(lp3, lp4, tid, rows, rp);
    const int lp5 = lev(l + 5);
    if (kCluster)
      cluster_wait();
    else
      grid_wait(bar, g);
    cur = nxt;
    nxt = far;
    lp0 = lp1;
    lp1 = lp2;
    lp2 = lp3;
    lp3 = lp4;
    lp4 = lp5;
  }
}

// The fewest 256-thread blocks that give each row of a `width`-row level
// its own thread, at most what the card holds at once; returns a
// cudaError_t.
template <typename V, typename F>
int grid_of(int width, int device, int* grid, int* per_sm, int* sms) {
  PTT_TRY(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, trisolve_kernel<V, F, false>, kGridThreads, 0));
  long long g = ((long long)width + kGridThreads - 1) / kGridThreads;
  const long long fill = (long long)*sms * (*per_sm < 1 ? 1 : *per_sm);
  if (g > fill) g = fill;
  *grid = g < 1 ? 1 : (int)g;
  return 0;
}

// Allows clusters above the portable 8 blocks for the cluster kernel, once
// per device.
template <typename V, typename F>
int allow_large_clusters(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device >= 0 && device < 64 ? 1ull << device : 0;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return 0;
  PTT_TRY(cudaFuncSetAttribute(trisolve_kernel<V, F, true>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  done.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

// A launch of one cluster of `blocks` blocks of `threads` threads.
inline void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                           int threads, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// With cfg, writes the launch shape there instead of launching: blocks,
// threads per block, blocks per SM (occupancy calculator), SMs, registers
// per thread, local (spill) bytes per thread, and for the cluster variant
// the clusters of this shape that the card can hold at once (else 0).
// cluster: 0 for the grid variant, else the cluster's blocks (1..16) of
// `threads` threads (32..512, a multiple of 32).
template <typename V, typename F>
int launch_trisolve(void* x, void* xl, const void* b, const void* lev_ptr, int nlev,
                    const void* rows, const void* rp, const void* pcols, const void* vals,
                    const void* scale, int width, int cluster, int threads, void* bar,
                    int device, void* stream, int* cfg) {
  PTT_TRY(cudaSetDevice(device));
  V* xp = (V*)x;
  V* xlp = (V*)xl;
  const V* bp = (const V*)b;
  const int* lp = (const int*)lev_ptr;
  const int* rw = (const int*)rows;
  const int* rpp = (const int*)rp;
  const int* cp = (const int*)pcols;
  const F* vp = (const F*)vals;
  const F* sp = (const F*)scale;
  unsigned int* br = (unsigned int*)bar;
  if (cluster) {
    if (cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > kClusterThreads ||
        threads % 32)
      return (int)cudaErrorInvalidConfiguration;
    const int err = allow_large_clusters<V, F>(device);
    if (err) return err;
    cudaLaunchConfig_t lc;
    cudaLaunchAttribute attr;
    cluster_config(&lc, &attr, cluster, threads, (cudaStream_t)stream);
    if (cfg) {
      cudaFuncAttributes fa;
      PTT_TRY(cudaFuncGetAttributes(&fa, trisolve_kernel<V, F, true>));
      int per_sm = 0, sms = 0, fit = 0;
      PTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
      PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trisolve_kernel<V, F, true>,
                                                            threads, 0));
      PTT_TRY(cudaOccupancyMaxActiveClusters(&fit, trisolve_kernel<V, F, true>, &lc));
      const int out[7] = {cluster, threads, per_sm, sms, fa.numRegs, (int)fa.localSizeBytes, fit};
      memcpy(cfg, out, sizeof out);
      return 0;
    }
    PTT_TRY(cudaLaunchKernelEx(&lc, trisolve_kernel<V, F, true>, xp, xlp, bp, lp, nlev, rw, rpp,
                               cp, vp, sp, br));
    return (int)cudaGetLastError();
  }
  int grid = 1, per_sm = 0, sms = 0;
  const int err = grid_of<V, F>(width, device, &grid, &per_sm, &sms);
  if (err) return err;
  if (cfg) {
    cudaFuncAttributes fa;
    PTT_TRY(cudaFuncGetAttributes(&fa, trisolve_kernel<V, F, false>));
    const int out[7] = {grid, kGridThreads, per_sm, sms, fa.numRegs, (int)fa.localSizeBytes, 0};
    memcpy(cfg, out, sizeof out);
    return 0;
  }
  void* args[] = {&xp, &xlp, &bp, &lp, &nlev, &rw, &rpp, &cp, &vp, &sp, &br};
  PTT_TRY(cudaLaunchCooperativeKernel((const void*)trisolve_kernel<V, F, false>, dim3(grid),
                                      dim3(kGridThreads), args, 0, (cudaStream_t)stream));
  return (int)cudaGetLastError();
}

template <typename V>
int dispatch(int fac64, void* x, void* xl, const void* b, const void* lev_ptr, int nlev,
             const void* rows, const void* rp, const void* pcols, const void* vals,
             const void* scale, int width, int cluster, int threads, void* bar, int device,
             void* stream, int* cfg) {
  return fac64 ? launch_trisolve<V, double>(x, xl, b, lev_ptr, nlev, rows, rp, pcols, vals,
                                            scale, width, cluster, threads, bar, device, stream,
                                            cfg)
               : launch_trisolve<V, float>(x, xl, b, lev_ptr, nlev, rows, rp, pcols, vals, scale,
                                           width, cluster, threads, bar, device, stream, cfg);
}

}  // namespace

// x, xl (scratch: x in level order), b: the vector type (f64 or f32);
// vals and scale (nullptr for none): double when fac64, else float;
// lev_ptr (nlev + 1), rows (m), rp (m + 1) and pcols (each entry's column
// as a level-order position): int32; width: the most rows of one level;
// cluster: 0 for the grid variant (bar: two 32-bit zeros that every
// launch leaves as it found the first), else the cluster variant's blocks
// of `threads` threads (bar unused).
extern "C" int ptt_trisolve_f64(void* x, void* xl, const void* b, const void* lev_ptr, int nlev,
                                const void* rows, const void* rp, const void* pcols,
                                const void* vals, const void* scale, int fac64, int width,
                                int cluster, int threads, void* bar, int device, void* stream) {
  return dispatch<double>(fac64, x, xl, b, lev_ptr, nlev, rows, rp, pcols, vals, scale, width,
                          cluster, threads, bar, device, stream, nullptr);
}

extern "C" int ptt_trisolve_f32(void* x, void* xl, const void* b, const void* lev_ptr, int nlev,
                                const void* rows, const void* rp, const void* pcols,
                                const void* vals, const void* scale, int fac64, int width,
                                int cluster, int threads, void* bar, int device, void* stream) {
  return dispatch<float>(fac64, x, xl, b, lev_ptr, nlev, rows, rp, pcols, vals, scale, width,
                         cluster, threads, bar, device, stream, nullptr);
}

// The launch shape of a sweep whose widest level has `width` rows, in the
// variant that `cluster` and `threads` name (see launch_trisolve); cfg
// takes 7 ints.
extern "C" int ptt_trisolve_config(int vec64, int fac64, int width, int cluster, int threads,
                                   int device, int* cfg) {
  return vec64 ? dispatch<double>(fac64, nullptr, nullptr, nullptr, nullptr, 0, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, width, cluster, threads, nullptr,
                                  device, nullptr, cfg)
               : dispatch<float>(fac64, nullptr, nullptr, nullptr, nullptr, 0, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, width, cluster, threads, nullptr,
                                 device, nullptr, cfg);
}
