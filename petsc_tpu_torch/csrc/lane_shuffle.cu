// K5: lane shuffle within 128-wide rows  o[r, l] = V[r, s[r, l]]
// (V, s and o are C x 128, row-major), f64 and f32.
//
// Replaces examples/pallas_shuffle_probe.py:60 probe_s1
// (jnp.take_along_axis(V, s, axis=1) on VMEM blocks inside a Pallas kernel).
//
// Bound: the bytes, V and s read once and o written once; no arithmetic.
// Design: a block of 256 threads takes two rows per step of a grid-stride
// loop. It stages the two V rows in shared memory with one coalesced load,
// then every thread reads its s[r, l] (coalesced), picks V[r, s] from
// shared memory and writes o[r, l] (coalesced): the unordered reads hit
// shared memory, never device memory. The loop's trip count is uniform
// across the block, so every thread reaches both barriers. Lane indices
// are taken as given, as in the other gathers: the wrapper checks them
// unless its caller vouches for them.
#include "common.cuh"

constexpr int kRow = 128;
constexpr int kRowsPerStep = ptt::kThreads / kRow;

template <typename T>
__global__ void __launch_bounds__(ptt::kThreads)
lane_shuffle_kernel(T* __restrict__ o, const T* __restrict__ V, const int* __restrict__ s,
                    long long C) {
  __shared__ T rows[kRowsPerStep * kRow];
  const int t = threadIdx.x;
  const int r_in_step = t / kRow;
  for (long long r0 = (long long)blockIdx.x * kRowsPerStep; r0 < C;
       r0 += (long long)gridDim.x * kRowsPerStep) {
    const long long r = r0 + r_in_step;
    const long long e = r * kRow + (t % kRow);
    if (r < C) rows[t] = V[e];
    __syncthreads();
    if (r < C) o[e] = rows[r_in_step * kRow + s[e]];
    __syncthreads();
  }
}

template <typename T>
static int launch_lane_shuffle(void* o, const void* V, const void* s, long long C, int device,
                               void* stream) {
  PTT_TRY(cudaSetDevice(device));
  lane_shuffle_kernel<T><<<ptt::grid_for(C * kRow, device, 1LL << 30), ptt::kThreads, 0,
                           (cudaStream_t)stream>>>((T*)o, (const T*)V, (const int*)s, C);
  return (int)cudaGetLastError();
}

extern "C" int ptt_lane_shuffle_f64(void* o, const void* V, const void* s, long long C,
                                    int device, void* stream) {
  return launch_lane_shuffle<double>(o, V, s, C, device, stream);
}

extern "C" int ptt_lane_shuffle_f32(void* o, const void* V, const void* s, long long C,
                                    int device, void* stream) {
  return launch_lane_shuffle<float>(o, V, s, C, device, stream);
}
