// The grid-barrier design of T1 (the level-scheduled triangular sweep,
// petsc_tpu/ops/trisolve.py:94-119 trisolve_apply and its sweeps), as
// petsc_tpu_torch/csrc/trisolve.cu had it before the cluster variant and
// the loads ahead of each level replaced it. It is not part of the
// package's kernel library: chip_smoke.py builds it on its own (one nvcc
// into petsc_tpu_torch/_build/earlier-<hash>/) only to time the two
// designs in turns on one card, on the same sweeps. The kernel is the
// earlier one unchanged; only the entry points are renamed
// (ptt_earlier_trisolve_*) and PTT_TRY is defined here.
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
// of one level sets the time, far above that bound.
// Design for that depth:
// - One cooperative launch per sweep (cudaLaunchCooperativeKernel: every
//   block resident at once, so a grid barrier cannot deadlock), a grid
//   barrier between levels, no level loop on the host. The grid is the
//   fewest blocks that give each row of the widest level its own thread,
//   capped by what the card holds at once (occupancy calculator); fewer
//   blocks make the barrier cheaper. A grid too large for the card is
//   refused by the launch (error 720) and the wrapper raises.
// - The rows are stored in level order with their entries contiguous
//   (CSR in level order, int32), so a level's threads read neighbouring
//   row pointers, columns and values; the row's scale is stored in level
//   order too.
// - Visibility: a row reads x written by other blocks in earlier levels.
//   The barrier fences (__threadfence before arriving and after leaving),
//   and x is read with __ldcg, from L2 past the SM's L1, which may hold a
//   stale line of x from an earlier level (x is not __restrict__, so no
//   read of it moves across the barrier).
// - Equal bits with the plain version: each product and sum is rounded
//   on its own (no fused multiply-add), a row's entries summed in column
//   order from 0, then b minus the sum, then the scale, in the type that
//   the factor and vector types promote to (double unless both are
//   float), and the result rounded to the vector's type.
// The grid barrier's two counters are scratch that the wrapper owns per
// stream; the kernel leaves the arrival count at 0.
#include <cuda_runtime.h>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace {

constexpr int kThreads = 256;

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

// Every block of the grid waits here until all have arrived. bar[0]
// counts arrivals (back to 0 when the last one arrives), bar[1] is the
// generation that the last arrival advances.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename V, typename F>
__global__ void __launch_bounds__(kThreads)
trisolve_kernel(V* x, const V* __restrict__ b, const int* __restrict__ lev_ptr,
                int nlev, const int* __restrict__ rows, const int* __restrict__ rp,
                const int* __restrict__ cols, const F* __restrict__ vals,
                const F* __restrict__ scale, unsigned int* bar) {
  using A = typename Acc<V, F>::type;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int l = 0; l < nlev; ++l) {
    const int p1 = __ldg(lev_ptr + l + 1);
    for (int p = __ldg(lev_ptr + l) + tid; p < p1; p += stride) {
      const int r = __ldg(rows + p);
      const int e1 = __ldg(rp + p + 1);
      A s = A(0);
      for (int e = __ldg(rp + p); e < e1; ++e)
        s = add_rn(s, mul_rn((A)__ldg(vals + e), (A)__ldcg(x + __ldg(cols + e))));
      A v = sub_rn((A)b[r], s);
      if (scale) v = mul_rn(v, (A)__ldg(scale + p));
      __stcg(x + r, (V)v);
    }
    if (l + 1 < nlev) grid_barrier(bar);
  }
}

// The fewest blocks that give each row of a `width`-row level its own
// thread, at most what the card holds at once; returns a cudaError_t.
template <typename V, typename F>
int grid_of(int width, int device, int* grid, int* per_sm, int* sms) {
  PTT_TRY(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device));
  PTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, trisolve_kernel<V, F>, kThreads,
                                                        0));
  long long g = ((long long)width + kThreads - 1) / kThreads;
  const long long fill = (long long)*sms * (*per_sm < 1 ? 1 : *per_sm);
  if (g > fill) g = fill;
  *grid = g < 1 ? 1 : (int)g;
  return 0;
}

// With cfg, writes the launch shape there (blocks, threads per block,
// blocks per SM, SMs) instead of launching.
template <typename V, typename F>
int launch_trisolve(void* x, const void* b, const void* lev_ptr, int nlev, const void* rows,
                    const void* rp, const void* cols, const void* vals, const void* scale,
                    int width, void* bar, int device, void* stream, int* cfg) {
  PTT_TRY(cudaSetDevice(device));
  int grid = 1, per_sm = 0, sms = 0;
  const int err = grid_of<V, F>(width, device, &grid, &per_sm, &sms);
  if (err) return err;
  if (cfg) {
    cfg[0] = grid;
    cfg[1] = kThreads;
    cfg[2] = per_sm;
    cfg[3] = sms;
    return 0;
  }
  V* xp = (V*)x;
  const V* bp = (const V*)b;
  const int* lp = (const int*)lev_ptr;
  const int* rw = (const int*)rows;
  const int* rpp = (const int*)rp;
  const int* cp = (const int*)cols;
  const F* vp = (const F*)vals;
  const F* sp = (const F*)scale;
  unsigned int* br = (unsigned int*)bar;
  void* args[] = {&xp, &bp, &lp, &nlev, &rw, &rpp, &cp, &vp, &sp, &br};
  PTT_TRY(cudaLaunchCooperativeKernel((const void*)trisolve_kernel<V, F>, dim3(grid),
                                      dim3(kThreads), args, 0, (cudaStream_t)stream));
  return (int)cudaGetLastError();
}

template <typename V>
int dispatch(int fac64, void* x, const void* b, const void* lev_ptr, int nlev, const void* rows,
             const void* rp, const void* cols, const void* vals, const void* scale, int width,
             void* bar, int device, void* stream, int* cfg) {
  return fac64 ? launch_trisolve<V, double>(x, b, lev_ptr, nlev, rows, rp, cols, vals, scale,
                                            width, bar, device, stream, cfg)
               : launch_trisolve<V, float>(x, b, lev_ptr, nlev, rows, rp, cols, vals, scale,
                                           width, bar, device, stream, cfg);
}

}  // namespace

// x, b: the vector type (f64 or f32); vals and scale (nullptr for none):
// double when fac64, else float; lev_ptr (nlev + 1), rows (m), rp (m + 1)
// and cols: int32; width: the most rows of one level; bar: two 32-bit
// zeros that every launch leaves as it found the first.
extern "C" int ptt_earlier_trisolve_f64(void* x, const void* b, const void* lev_ptr, int nlev,
                                const void* rows, const void* rp, const void* cols,
                                const void* vals, const void* scale, int fac64, int width,
                                void* bar, int device, void* stream) {
  return dispatch<double>(fac64, x, b, lev_ptr, nlev, rows, rp, cols, vals, scale, width, bar,
                          device, stream, nullptr);
}

extern "C" int ptt_earlier_trisolve_f32(void* x, const void* b, const void* lev_ptr, int nlev,
                                const void* rows, const void* rp, const void* cols,
                                const void* vals, const void* scale, int fac64, int width,
                                void* bar, int device, void* stream) {
  return dispatch<float>(fac64, x, b, lev_ptr, nlev, rows, rp, cols, vals, scale, width, bar,
                         device, stream, nullptr);
}

// The launch shape of a sweep whose widest level has `width` rows.
extern "C" int ptt_earlier_trisolve_config(int vec64, int fac64, int width, int device, int* cfg) {
  return vec64 ? dispatch<double>(fac64, nullptr, nullptr, nullptr, 0, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, width, nullptr, device, nullptr, cfg)
               : dispatch<float>(fac64, nullptr, nullptr, nullptr, 0, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, width, nullptr, device, nullptr, cfg);
}
