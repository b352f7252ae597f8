// V1: the variable-coefficient grid stencil SpMV, f64 and f32.
//
// Replaces the variable-coefficient mult of petsc_tpu/mat/aij.py
// _bind_aij_dnd (the slab branch :1393-1426 and the generic branch
// :1427-1436, which give the same y): on an n0 x n1 x n2 grid (C order;
// 1-D and 2-D grids padded with leading unit axes),
//   y(i) = sum_k c_k(i) x(i + o_k),   x zero outside the grid,
// where each c_k is either a coefficient plane (coef[plane_k], n0 n1 n2
// values) or one constant for the whole grid (meta[6] of the reference's
// stencil). On the main path these are the probed coarse levels of the
// structured GAMG head: 27 planes of a {-1,0,1}^3 stencil.
//
// Bound: device-memory bandwidth. Each point reads its plane values once,
// x once and writes y once: (planes + 2) n itemsize bytes (60.8 MB, 0.0182
// ms at 3.35 TB/s for 27 planes in f64 at 64^3), about 2 flops per tap.
// Design for that bound, simple first: one output per thread in a
// grid-stride loop over the flat index, so the plane reads of a warp are
// 32 consecutive values of each plane (coalesced, read once) and the x
// reads of the taps fall on the rows around the warp's, which the L1 and
// L2 serve after their first use. The taps (offsets, plane index or
// constant) arrive by value in the kernel's parameters. Each product and
// sum is rounded on its own (no fused multiply-add), in the taps' order,
// so y equals the plain PyTorch version's bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxTaps = 128;

struct Taps {
  int count;
  int off[kMaxTaps][3];    // (d0, d1, d2)
  int plane[kMaxTaps];     // the coefficient plane, or -1 for a constant
  double c[kMaxTaps];      // the constant where plane < 0
};

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
dnd_stencil_kernel(T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ coef,
                   int n0, int n1, int n2, const Taps taps) {
  const int n = n0 * n1 * n2;
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    const int i2 = p % n2;
    const int q = p / n2;
    const int i1 = q % n1;
    const int i0 = q / n1;
    T acc = T(0);
    for (int k = 0; k < taps.count; ++k) {
      const int j0 = i0 + taps.off[k][0], j1 = i1 + taps.off[k][1], j2 = i2 + taps.off[k][2];
      const bool in = j0 >= 0 && j0 < n0 && j1 >= 0 && j1 < n1 && j2 >= 0 && j2 < n2;
      const T xv = in ? __ldg(x + (j0 * n1 + j1) * n2 + j2) : T(0);
      const int pl = taps.plane[k];
      const T c = pl >= 0 ? __ldg(coef + (long long)pl * n + p) : (T)taps.c[k];
      acc = add_rn(acc, mul_rn(c, xv));
    }
    y[p] = acc;
  }
}

template <typename T>
int launch_dnd_stencil(void* y, const void* x, const void* coef, int n0, int n1, int n2,
                       int count, const int* off, const int* plane, const double* c,
                       int device, void* stream) {
  if (count < 0 || count > kMaxTaps) return (int)cudaErrorInvalidValue;
  PTT_TRY(cudaSetDevice(device));
  Taps taps;
  taps.count = count;
  for (int k = 0; k < count; ++k) {
    for (int d = 0; d < 3; ++d) taps.off[k][d] = off[3 * k + d];
    taps.plane[k] = plane[k];
    taps.c[k] = c[k];
  }
  const long long n = (long long)n0 * n1 * n2;
  dnd_stencil_kernel<T><<<ptt::grid_for(n, device, 1LL << 30), ptt::kThreads, 0,
                          (cudaStream_t)stream>>>((T*)y, (const T*)x, (const T*)coef, n0, n1,
                                                  n2, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// y, x: n0 n1 n2 values (fewer than 2^31); coef: the planes, each n0 n1 n2
// values; off: 3 ints per tap, plane: one int per tap (-1: the constant
// c[k]); host arrays, read before the launch.
extern "C" int ptt_dnd_stencil_f64(void* y, const void* x, const void* coef, int n0, int n1,
                                   int n2, int count, const int* off, const int* plane,
                                   const double* c, int device, void* stream) {
  return launch_dnd_stencil<double>(y, x, coef, n0, n1, n2, count, off, plane, c, device,
                                    stream);
}

extern "C" int ptt_dnd_stencil_f32(void* y, const void* x, const void* coef, int n0, int n1,
                                   int n2, int count, const int* off, const int* plane,
                                   const double* c, int device, void* stream) {
  return launch_dnd_stencil<float>(y, x, coef, n0, n1, n2, count, off, plane, c, device,
                                   stream);
}
