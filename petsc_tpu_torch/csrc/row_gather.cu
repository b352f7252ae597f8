// K6: row gather  o[c, :] = x2[q[c], :]  (x2 is B x w, o is C x w, row-major),
// f64 and f32.
//
// Replaces examples/pallas_shuffle_probe.py:92 probe_s2 (jnp.take(x2, q,
// axis=0) on a VMEM-resident x2 inside a Pallas kernel).
//
// Bound: the bytes, q read once, o written once and the distinct rows of
// x2 read once; no arithmetic. Design: one warp per output row in a
// grid-stride loop; the 32 lanes stride the row, so each source row is
// read and each output row written as whole, coalesced lines. x2 (2-4 MB
// at the probe's size) is read through the read-only path and stays in L2.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
row_gather_kernel(T* __restrict__ o, const T* __restrict__ x2, const int* __restrict__ q,
                  long long C, int w) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < C; c += nwarps) {
    const T* src = x2 + (long long)q[c] * w;
    T* dst = o + c * w;
    for (int l = lane; l < w; l += 32) dst[l] = __ldg(src + l);
  }
}

template <typename T>
static int launch_row_gather(void* o, const void* x2, const void* q, long long C, int w,
                             int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  row_gather_kernel<T><<<ptt::grid_for(C * 32, device, 1LL << 30), ptt::kThreads, 0,
                         (cudaStream_t)stream>>>((T*)o, (const T*)x2, (const int*)q, C, w);
  return (int)cudaGetLastError();
}

extern "C" int ptt_row_gather_f64(void* o, const void* x2, const void* q, long long C, int w,
                                  int device, void* stream) {
  return launch_row_gather<double>(o, x2, q, C, w, device, stream);
}

extern "C" int ptt_row_gather_f32(void* o, const void* x2, const void* q, long long C, int w,
                                  int device, void* stream) {
  return launch_row_gather<float>(o, x2, q, C, w, device, stream);
}
