// K8 and K7: flat gathers from a resident vector, f64 and f32.
//
//   K8 gather   o[i] = x[idx[i]]
//      replaces examples/pallas_gather_probe.py:50 probe_g1 (jnp.take of a
//      VMEM-resident x inside a Pallas kernel). On the port's path it is the
//      COO numeric assembly's v[perm] and the diagonal refresh
//      csr_vals[diag_pos] (petsc_tpu/mat/aij.py:208-222, :896-899).
//   K7 gather2  o[i] = x2[w * q[i] + s[i]]   (x2 is B x w, row-major)
//      replaces examples/pallas_shuffle_probe.py:125 probe_s3 (a row take
//      then a lane take_along_axis inside VMEM). The same device code as K8
//      with the index formed in the kernel.
//
// Bound: the bytes, the index arrays read once, o written once and the
// 32-byte sectors of x that the indices touch read once (a sector is the
// least the memory moves: the diagonal refresh reads one 8-byte entry out
// of every 216 bytes, a sector each); no arithmetic. Design: a grid-stride
// loop, one output per thread per step, so idx (or q and s) and o stream
// coalesced; x is read through the read-only path and, at the probes'
// sizes (x of 2-4 MB), stays in L2. The grid (8 blocks of 256 threads
// per SM) already has about 270 k loads in flight at once; giving each
// thread 8 outputs with all their loads issued first measured 1-3 %
// slower in float64 at each of the three shapes (PERF.md, K8). The
// wrapper checks the index type (int32), the index width (x holds fewer
// than 2^31 entries) and, unless the caller built the indices itself,
// their bounds.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
gather_kernel(T* __restrict__ o, const T* __restrict__ x, const int* __restrict__ idx, long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride)
    o[i] = __ldg(x + idx[i]);
}

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
gather2_kernel(T* __restrict__ o, const T* __restrict__ x2, const int* __restrict__ q,
               const int* __restrict__ s, long long m, int w) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride)
    o[i] = __ldg(x2 + ((long long)q[i] * w + s[i]));
}

template <typename T>
static int launch_gather(void* o, const void* x, const void* idx, long long m, int device,
                         void* stream) {
  PTT_TRY(cudaSetDevice(device));
  gather_kernel<T><<<ptt::grid_for(m, device, 1LL << 30), ptt::kThreads, 0, (cudaStream_t)stream>>>(
      (T*)o, (const T*)x, (const int*)idx, m);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_gather2(void* o, const void* x2, const void* q, const void* s, long long m,
                          int w, int device, void* stream) {
  PTT_TRY(cudaSetDevice(device));
  gather2_kernel<T><<<ptt::grid_for(m, device, 1LL << 30), ptt::kThreads, 0, (cudaStream_t)stream>>>(
      (T*)o, (const T*)x2, (const int*)q, (const int*)s, m, w);
  return (int)cudaGetLastError();
}

extern "C" int ptt_gather_f64(void* o, const void* x, const void* idx, long long m, int device,
                              void* stream) {
  return launch_gather<double>(o, x, idx, m, device, stream);
}

extern "C" int ptt_gather_f32(void* o, const void* x, const void* idx, long long m, int device,
                              void* stream) {
  return launch_gather<float>(o, x, idx, m, device, stream);
}

extern "C" int ptt_gather2_f64(void* o, const void* x2, const void* q, const void* s, long long m,
                               int w, int device, void* stream) {
  return launch_gather2<double>(o, x2, q, s, m, w, device, stream);
}

extern "C" int ptt_gather2_f32(void* o, const void* x2, const void* q, const void* s, long long m,
                               int w, int device, void* stream) {
  return launch_gather2<float>(o, x2, q, s, m, w, device, stream);
}
