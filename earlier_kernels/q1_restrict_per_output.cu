// The per-output design of Q1R, the exact adjoint of the factor-2 vertex
// Q1 prolongation (petsc_tpu/dm/interp.py _restrict_axis :49-71, composed
// at :229-235), that petsc_tpu_torch/csrc/q1.cu's march replaced. It is
// not part of the package's kernel library: chip_smoke.py builds it on its
// own (one nvcc into petsc_tpu_torch/_build/earlier-<hash>/) only to time
// the two designs in turns on one card, on the same inputs.
//
// One output per thread in a grid-stride loop over the flat coarse index:
// two divisions and modulos per coarse point, the taps of each axis in a
// loop of variable trip count, up to 27 scalar __ldg's (consecutive lanes
// read fine points 2 apart, and each fine value is loaded by every coarse
// neighbour that sums it, about 3.4 times in all). Per axis c[j] = f[2j] +
// 0.5 f[2j+1] (odd nf: j < nc - 1) + 0.5 f[2j-1] (j >= 1), and at an even
// nf the last coarse point adds 0.5 f[nf-1] once more; the axes are
// applied 2, 1, 0, each product and sum rounded on its own, so it equals
// the plain version bit for bit, as the new design does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
earlier_q1_restrict_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2,
                           int c0, int c1, int c2) {
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

// The grid of the package's streaming kernels: every SM filled with 8
// blocks of kThreads, never more blocks than the work needs.
int grid_for(long long work, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms < 1)
    sms = 132;
  long long g = (work + kThreads - 1) / kThreads;
  if (g > (long long)sms * 8) g = (long long)sms * 8;
  return g < 1 ? 1 : (int)g;
}

template <typename T>
int launch(void* y, const void* x, int f0, int f1, int f2, int c0, int c1, int c2, int device,
           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)c0 * c1 * c2;
  earlier_q1_restrict_kernel<T><<<grid_for(n, device), kThreads, 0, (cudaStream_t)stream>>>(
      (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  return (int)cudaGetLastError();
}

}  // namespace

// (f0, f1, f2): the fine grid, (c0, c1, c2) = ((f + 1) / 2 per axis): the
// coarse one, fewer than 2^31 points; x fine, y coarse.
extern "C" int ptt_earlier_q1_restrict_f64(void* y, const void* x, int f0, int f1, int f2,
                                           int c0, int c1, int c2, int device, void* stream) {
  return launch<double>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}

extern "C" int ptt_earlier_q1_restrict_f32(void* y, const void* x, int f0, int f1, int f2,
                                           int c0, int c1, int c2, int device, void* stream) {
  return launch<float>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}
