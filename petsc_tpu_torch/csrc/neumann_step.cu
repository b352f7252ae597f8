// N1: the Neumann step of the truncated-Neumann triangular solve, f64 and f32.
//
//   z = dinv * (y - w)
//
// Replaces the step z <- dinv * (y - U z) of petsc_tpu/pc/factor_pc.py:331-333
// (-pc_factor_trisolve neumann; w = U z is the product before it, on V1 or
// S2), which XLA fuses on the TPU. One pass: dinv, y and w read once, z
// written once; the subtraction then the product, each rounded as the plain
// version rounds it (no FMA can form), so the bits equal its.
// Bound: device-memory bandwidth, 4 n itemsize bytes for 2 n flops.
// Design: a grid-stride loop of one element per thread per step (the K8
// gather's shape), the grid one wave of 8 blocks of 256 threads per SM.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
neumann_step_kernel(T* __restrict__ z, const T* __restrict__ dinv, const T* __restrict__ y,
                    const T* __restrict__ w, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    z[i] = __ldg(dinv + i) * (__ldg(y + i) - __ldg(w + i));
}

template <typename T>
int launch(void* z, const void* dinv, const void* y, const void* w, long long n, int device,
           void* stream) {
  PTT_TRY(cudaSetDevice(device));
  neumann_step_kernel<T><<<ptt::grid_for(n, device, 1LL << 30), ptt::kThreads, 0,
                           (cudaStream_t)stream>>>((T*)z, (const T*)dinv, (const T*)y,
                                                   (const T*)w, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_neumann_step_f64(void* z, const void* dinv, const void* y, const void* w,
                                    long long n, int device, void* stream) {
  return launch<double>(z, dinv, y, w, n, device, stream);
}

extern "C" int ptt_neumann_step_f32(void* z, const void* dinv, const void* y, const void* w,
                                    long long n, int device, void* stream) {
  return launch<float>(z, dinv, y, w, n, device, stream);
}
