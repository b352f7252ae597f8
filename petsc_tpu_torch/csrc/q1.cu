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
// Each output is one thread's nested sum in the reference's order of
// operations (the inner axis first, each product and sum rounded on its
// own), so it equals the per-axis composition bit for bit, and no output
// is written by two threads (a gather, no atomics).
//
// Bound: device-memory bandwidth, the fine and the coarse vector each
// moved once: (nf + nc) itemsize bytes (18.9 MB, 0.0056 ms at 3.35 TB/s
// for 128^3 <- 64^3 in f64). Design, simple first: one output per thread
// in a grid-stride loop over the flat index. A prolongation thread reads
// at most 8 coarse values, which its neighbours share through the L1; a
// restriction thread reads at most 4 x 4 x 4 fine values (27 inside the
// grid), each also read by the neighbouring coarse points' threads, so
// the fine vector streams through the L1 and L2 about 3.4 times in all.
#include "common.cuh"

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// The coarse points that fine point f reads along one axis: 1 or 2.
__device__ __forceinline__ int prolong_taps(int f, int nc, int (&t)[2]) {
  t[0] = f >> 1;
  if ((f & 1) == 0) return 1;
  t[1] = min(t[0] + 1, nc - 1);
  return 2;
}

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

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
q1_prolong_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2, int c0,
                  int c1, int c2) {
  const int n = f0 * f1 * f2;
  const int stride = gridDim.x * blockDim.x;
  const T half = T(0.5);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int i2 = p % f2;
    const int q = p / f2;
    const int i1 = q % f1;
    const int i0 = q / f1;
    int t0[2], t1[2], t2[2];
    const int m0 = prolong_taps(i0, c0, t0);
    const int m1 = prolong_taps(i1, c1, t1);
    const int m2 = prolong_taps(i2, c2, t2);
    T v2[2];
    for (int b2 = 0; b2 < m2; ++b2) {
      T v1[2];
      for (int b1 = 0; b1 < m1; ++b1) {
        const int base = t1[b1] * c2 + t2[b2];
        T v0 = __ldg(x + t0[0] * c1 * c2 + base);
        if (m0 == 2) v0 = mul_rn(half, add_rn(v0, __ldg(x + t0[1] * c1 * c2 + base)));
        v1[b1] = v0;
      }
      v2[b2] = m1 == 2 ? mul_rn(half, add_rn(v1[0], v1[1])) : v1[0];
    }
    y[p] = m2 == 2 ? mul_rn(half, add_rn(v2[0], v2[1])) : v2[0];
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

template <typename T, bool kProlong>
int launch_q1(void* y, const void* x, int f0, int f1, int f2, int c0, int c1, int c2,
              int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  const long long n = kProlong ? (long long)f0 * f1 * f2 : (long long)c0 * c1 * c2;
  const int grid = ptt::grid_for(n, device, 1LL << 30);
  if (kProlong)
    q1_prolong_kernel<T><<<grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  else
    q1_restrict_kernel<T><<<grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
        (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  return (int)cudaGetLastError();
}

}  // namespace

// (f0, f1, f2): the fine grid, (c0, c1, c2) = ((f + 1) / 2 per axis): the
// coarse one; both hold fewer than 2^31 points. prolong: x coarse, y fine;
// restrict: x fine, y coarse.
extern "C" int ptt_q1_prolong_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                  int c1, int c2, int device, void* stream) {
  return launch_q1<double, true>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}

extern "C" int ptt_q1_prolong_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                  int c1, int c2, int device, void* stream) {
  return launch_q1<float, true>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}

extern "C" int ptt_q1_restrict_f64(void* y, const void* x, int f0, int f1, int f2, int c0,
                                   int c1, int c2, int device, void* stream) {
  return launch_q1<double, false>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}

extern "C" int ptt_q1_restrict_f32(void* y, const void* x, int f0, int f1, int f2, int c0,
                                   int c1, int c2, int device, void* stream) {
  return launch_q1<float, false>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}
