// Q1P and Q1R: the factor-2 vertex Q1 prolongation and its exact adjoint,
// fused over the axes, f64 and f32.
//
// Replaces petsc_tpu/dm/interp.py _interp_axis (:21-46) and
// _restrict_axis (:49-71), which _bind_interp_q1 (:219-235) and the GAMG
// head's probe (petsc_tpu/pc/gamg_device.py:92-102) compose axis by axis.
// Per axis, nc = (nf + 1) / 2 coarse points feed nf fine points: an even
// fine point f takes coarse f/2; an odd one takes 0.5 (c[f/2] + c[hi]),
// hi = min(f/2 + 1, nc - 1), so at an even nf the last odd point clamps
// to its one neighbour (0.5 (c + c) = c). Grids of 1-3 axes, padded with
// leading unit axes (nf = nc = 1).
//   q1_prolong:  y (fine) = P x (coarse), the axes applied 0, 1, 2;
//   q1_restrict: y (coarse) = P^T x (fine), the axes applied 2, 1, 0; per
//                axis c[j] = f[2j] + 0.5 f[2j+1] (odd nf: j < nc - 1)
//                + 0.5 f[2j-1] (j >= 1), and at an even nf the last
//                coarse point adds 0.5 f[nf-1] once more (the clamp).
// Every output is the reference's nested sum in its order of operations
// (the inner axis first, each product and sum rounded on its own), so it
// equals the per-axis composition bit for bit, and no output is written
// by two threads (no atomics).
//
// Bound: device-memory bandwidth, the fine and the coarse vector each
// moved once: (nf + nc) itemsize bytes (18.9 MB, 0.0056 ms at 3.35 TB/s
// for 128^3 <- 64^3 in f64; 9.4 MB, 0.0028 ms in f32). 8/9 of Q1P's bytes
// are stores.
//
// Q1P: one thread per coarse cell (j0, j1, j2), launched on a 3-D grid
// (no division per point). The thread loads the cell's 2 x 2 x 2 coarse
// neighbourhood once (hi clamped at the last coarse point), forms the
// axis-0, then axis-1, then axis-2 combinations and writes the cell's up
// to 8 fine points 2j .. 2j+1 per axis: one load serves 8 outputs. An
// intermediate that several outputs share is the same expression in each,
// so it has the same bits. At an odd nf the last cell of the axis writes
// only its even point. With an even f2 every cell has both points along
// i2 and every row starts on an even element, so the pair is one 8-byte
// (f32) or 16-byte (f64) store; with an odd f2 the wrapper
// (ops/grid_kernels.py _q1_prolong_plan) takes the scalar-store variant.
//
// Q1R, simple first: one output per thread in a grid-stride loop over the
// flat index; a thread reads at most 4 x 4 x 4 fine values (27 inside the
// grid), each also read by the neighbouring coarse points' threads, so the
// fine vector streams through the L1 and L2 about 3.4 times in all.
#include "common.cuh"

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// The fine points that coarse point j sums along one axis, in the
// reference's order: the first with weight 1, the others with 0.5.
__device__ __forceinline__ int restrict_taps(int j, int nf, int nc, int (&t)[4]) {
  int m = 0;
  t[m++] = 2 * j;
  if (nf & 1) {
    if (j < nc - 1) t[m++] = 2 * j + 1;
    if (j >= 1) t[m++] = 2 * j - 1;
  } else {
    t[m++] = 2 * j + 1;
    if (j >= 1) t[m++] = 2 * j - 1;
    if (j == nc - 1) t[m++] = 2 * j + 1;
  }
  return m;
}

// The pair (2 j2, 2 j2 + 1) of one fine row: one 8- or 16-byte store.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// One thread per coarse cell: blockIdx.x / threadIdx.x walk j2,
// blockIdx.y / threadIdx.y j1, blockIdx.z j0 (each striding by its grid).
template <typename T, bool kPair>
__global__ void __launch_bounds__(ptt::kThreads)
q1_prolong_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2, int c0,
                  int c1, int c2) {
  const int j2 = blockIdx.x * blockDim.x + threadIdx.x;
  if (j2 >= c2) return;
  const T half = T(0.5);
  const int h2 = min(j2 + 1, c2 - 1);
  const bool odd2 = 2 * j2 + 1 < f2;
  for (int j1 = blockIdx.y * blockDim.y + threadIdx.y; j1 < c1; j1 += gridDim.y * blockDim.y) {
    const int r1[2] = {j1, min(j1 + 1, c1 - 1)};
    for (int j0 = blockIdx.z; j0 < c0; j0 += gridDim.z) {
      const int r0[2] = {j0, min(j0 + 1, c0 - 1)};
      T v[2][2][2];   // v[a0][a1][a2]: coarse (r0[a0], r1[a1], j2 or h2)
#pragma unroll
      for (int a0 = 0; a0 < 2; ++a0)
#pragma unroll
        for (int a1 = 0; a1 < 2; ++a1) {
          const T* row = x + ((long long)r0[a0] * c1 + r1[a1]) * c2;
          v[a0][a1][0] = __ldg(row + j2);
          v[a0][a1][1] = __ldg(row + h2);
        }
#pragma unroll
      for (int p0 = 0; p0 < 2; ++p0) {
        if (p0 && 2 * j0 + 1 >= f0) break;
        T a[2][2];   // axis 0: the even fine plane takes v[0], the odd one 0.5 (v[0] + v[1])
#pragma unroll
        for (int a1 = 0; a1 < 2; ++a1)
#pragma unroll
          for (int a2 = 0; a2 < 2; ++a2)
            a[a1][a2] = p0 ? mul_rn(half, add_rn(v[0][a1][a2], v[1][a1][a2])) : v[0][a1][a2];
#pragma unroll
        for (int p1 = 0; p1 < 2; ++p1) {
          if (p1 && 2 * j1 + 1 >= f1) break;
          T b[2];    // axis 1, likewise
#pragma unroll
          for (int a2 = 0; a2 < 2; ++a2)
            b[a2] = p1 ? mul_rn(half, add_rn(a[0][a2], a[1][a2])) : a[0][a2];
          T* const out = y + ((long long)(2 * j0 + p0) * f1 + (2 * j1 + p1)) * f2 + 2 * j2;
          // axis 2: the even point b[0], the odd one 0.5 (b[0] + b[1])
          if constexpr (kPair) {
            store_pair(out, b[0], mul_rn(half, add_rn(b[0], b[1])));
          } else {
            out[0] = b[0];
            if (odd2) out[1] = mul_rn(half, add_rn(b[0], b[1]));
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
q1_restrict_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2, int c0,
                   int c1, int c2) {
  const int n = c0 * c1 * c2;
  const int stride = gridDim.x * blockDim.x;
  const T half = T(0.5);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int j2 = p % c2;
    const int q = p / c2;
    const int j1 = q % c1;
    const int j0 = q / c1;
    int t0[4], t1[4], t2[4];
    const int m0 = restrict_taps(j0, f0, c0, t0);
    const int m1 = restrict_taps(j1, f1, c1, t1);
    const int m2 = restrict_taps(j2, f2, c2, t2);
    T r0 = T(0);
    for (int a0 = 0; a0 < m0; ++a0) {
      T r1 = T(0);
      for (int a1 = 0; a1 < m1; ++a1) {
        const T* row = x + (t0[a0] * f1 + t1[a1]) * f2;
        T r2 = __ldg(row + t2[0]);
        for (int a2 = 1; a2 < m2; ++a2) r2 = add_rn(r2, mul_rn(half, __ldg(row + t2[a2])));
        r1 = a1 == 0 ? r2 : add_rn(r1, mul_rn(half, r2));
      }
      r0 = a0 == 0 ? r1 : add_rn(r0, mul_rn(half, r1));
    }
    y[p] = r0;
  }
}

template <typename T>
int launch_prolong(void* y, const void* x, int f0, int f1, int f2, int c0, int c1, int c2,
                   int pair, int device, void* stream) {
  if (pair && f2 % 2) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  // 256 threads: 32 .. 256 along j2, the rest along j1 (8 rows when c1 >= 8)
  int by = 1;
  while (by < 8 && 2 * by <= c1) by *= 2;
  const int bx = ptt::kThreads / by;
  const dim3 block(bx, by);
  const dim3 grid((c2 + bx - 1) / bx, min((c1 + by - 1) / by, 65535), min(c0, 65535));
  if (pair)
    q1_prolong_kernel<T, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  else
    q1_prolong_kernel<T, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_restrict(void* y, const void* x, int f0, int f1, int f2, int c0, int c1, int c2,
                    int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  const int grid = ptt::grid_for((long long)c0 * c1 * c2, device, 1LL << 30);
  q1_restrict_kernel<T><<<grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
      (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  return (int)cudaGetLastError();
}

}  // namespace

// (f0, f1, f2): the fine grid, (c0, c1, c2) = ((f + 1) / 2 per axis): the
// coarse one; both hold fewer than 2^31 points. prolong: x coarse, y fine,
// pair: the vector-store variant (an even f2, y 16-byte aligned);
// restrict: x fine, y coarse.
extern "C" int ptt_q1_prolong_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                  int c1, int c2, int pair, int device, void* stream) {
  return launch_prolong<double>(y, x, f0, f1, f2, c0, c1, c2, pair, device, stream);
}

extern "C" int ptt_q1_prolong_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                  int c1, int c2, int pair, int device, void* stream) {
  return launch_prolong<float>(y, x, f0, f1, f2, c0, c1, c2, pair, device, stream);
}

extern "C" int ptt_q1_restrict_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                   int c1, int c2, int device, void* stream) {
  return launch_restrict<double>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}

extern "C" int ptt_q1_restrict_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                   int c1, int c2, int device, void* stream) {
  return launch_restrict<float>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}
