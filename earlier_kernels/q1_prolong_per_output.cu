// The per-output design of Q1P, the factor-2 vertex Q1 prolongation
// (petsc_tpu/dm/interp.py _interp_axis :21-46, composed at :219-227),
// that petsc_tpu_torch/csrc/q1.cu's per-cell kernel replaced. It is not
// part of the package's kernel library: chip_smoke.py builds it on its own
// (one nvcc into petsc_tpu_torch/_build/earlier-<hash>/) only to time the
// two designs in turns on one card, on the same inputs.
//
// One output per thread in a grid-stride loop over the flat fine index:
// three divisions and modulos per fine point, up to 8 scattered __ldg's,
// one 4- or 8-byte store. Per axis, nc = (nf + 1) / 2 coarse points feed
// nf fine points: an even fine point f takes coarse f/2; an odd one takes
// 0.5 (c[f/2] + c[hi]), hi = min(f/2 + 1, nc - 1); the axes are applied 0,
// 1, 2, each product and sum rounded on its own, so it equals the plain
// version bit for bit, as the new design does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
earlier_q1_prolong_kernel(T* __restrict__ y, const T* __restrict__ x, int f0, int f1, int f2,
                          int c0, int c1, int c2) {
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
  const long long n = (long long)f0 * f1 * f2;
  earlier_q1_prolong_kernel<T><<<grid_for(n, device), kThreads, 0, (cudaStream_t)stream>>>(
      (T*)y, (const T*)x, f0, f1, f2, c0, c1, c2);
  return (int)cudaGetLastError();
}

}  // namespace

// (f0, f1, f2): the fine grid, (c0, c1, c2) = ((f + 1) / 2 per axis): the
// coarse one, fewer than 2^31 points; x coarse, y fine.
extern "C" int ptt_earlier_q1_prolong_f64(void* y, const void* x, int f0, int f1, int f2,
                                          int c0, int c1, int c2, int device, void* stream) {
  return launch<double>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}

extern "C" int ptt_earlier_q1_prolong_f32(void* y, const void* x, int f0, int f1, int f2,
                                          int c0, int c1, int c2, int device, void* stream) {
  return launch<float>(y, x, f0, f1, f2, c0, c1, c2, device, stream);
}
