// The 16-row design of A1, the aggregate-block smoother's apply
// (petsc_tpu/pc/mg.py:516-525), as petsc_tpu_torch/csrc/agg_block.cu had
// it before the run items replaced it. It is not part of the package's
// kernel library: chip_smoke.py builds it on its own (one nvcc into
// petsc_tpu_torch/_build/earlier-<hash>/) only to time the two designs in
// turns on one card, on the same tables; its work list (work, three ints
// per item: block, first row, rows, at most 16) is chip_smoke.py's
// earlier_agg_work. The kernel is the earlier one unchanged; only the
// entry points are renamed (ptt_earlier_agg_block_apply_*) and PTT_TRY is
// defined here.
//
// A1: the aggregate-block smoother's apply z = M^-1 r, f64 and f32.
//
// Replaces the apply of -pc_gamg_asm_use_agg in petsc_tpu/pc/mg.py:516-525
// (gather r over each aggregate's dofs, a batched GEMV with the dense
// inverse of the aggregate's diagonal block, scatter-add; left to XLA on the
// TPU, with every block padded to the largest). Here the tables are ragged:
// aggregate a has k_a dofs d_a (dofs[dptr[a] : dptr[a+1]]) and its k_a x k_a
// inverse B_a row-major at inv[iptr[a] :]. Aggregates are disjoint and cover
// every dof (a dof outside all of them is a 1 x 1 block), so
//   z[d_a] = B_a r[d_a]
// stores each entry of z once, with no atomics.
//
// Bound: device-memory bandwidth: sum k_a^2 entries of B read once, plus r
// gathered, the dof lists and z stored once (about 61 MB in f64 at ex56 ne
// 24, level 0: 513 aggregates of up to 1,875 dofs).
// Design (a first, simple kernel): one work item per thread block, an
// aggregate and a range of at most 16 of its rows (the wrapper's work list
// splits a 1,875-dof block over 118 blocks, so large aggregates fill the
// card). The block gathers r[d_a] into shared memory (15 KB at k = 1,875 in
// f64), then each warp takes rows: its lanes read the row of B_a coalesced,
// multiply by the staged r, and sum by a butterfly of shuffles. The row
// sums are in another order than the plain version's batched product, so
// the two agree to rounding (the tolerance chip_smoke.py states).
#include <cuda_runtime.h>

#define PTT_TRY(expr)                                 \
  do {                                                \
    cudaError_t ptt_err_ = (expr);                    \
    if (ptt_err_ != cudaSuccess) return (int)ptt_err_; \
  } while (0)

namespace {

constexpr int kAggThreads = 128;
constexpr int kWarps = kAggThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kAggThreads)
agg_block_kernel(T* __restrict__ z, const T* __restrict__ r, const int* __restrict__ dofs,
                 const long long* __restrict__ dptr, const T* __restrict__ inv,
                 const long long* __restrict__ iptr, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int a = __ldg(work + 3 * (long long)blockIdx.x);
  const int i0 = __ldg(work + 3 * (long long)blockIdx.x + 1);
  const int nr = __ldg(work + 3 * (long long)blockIdx.x + 2);
  const long long d0 = __ldg(dptr + a);
  const int k = (int)(__ldg(dptr + a + 1) - d0);
  for (int j = threadIdx.x; j < k; j += kAggThreads) s[j] = __ldg(r + __ldg(dofs + d0 + j));
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* B = inv + __ldg(iptr + a);
  for (int i = i0 + warp; i < i0 + nr; i += kWarps) {
    const T* row = B + (long long)i * k;
    T acc = T(0);
    for (int j = lane; j < k; j += 32) acc += __ldg(row + j) * s[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) z[__ldg(dofs + d0 + i)] = acc;
  }
}

template <typename T>
int launch_agg(void* z, const void* r, const void* dofs, const void* dptr, const void* inv,
               const void* iptr, const void* work, int nitems, int max_k, int device,
               void* stream) {
  PTT_TRY(cudaSetDevice(device));
  if (nitems <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)max_k * sizeof(T);
  if (smem > kDefaultSmem)
    PTT_TRY(cudaFuncSetAttribute(agg_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
  agg_block_kernel<T><<<nitems, kAggThreads, smem, (cudaStream_t)stream>>>(
      (T*)z, (const T*)r, (const int*)dofs, (const long long*)dptr, (const T*)inv,
      (const long long*)iptr, (const int*)work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_earlier_agg_block_apply_f64(void* z, const void* r, const void* dofs, const void* dptr,
                                       const void* inv, const void* iptr, const void* work,
                                       int nitems, int max_k, int device, void* stream) {
  return launch_agg<double>(z, r, dofs, dptr, inv, iptr, work, nitems, max_k, device, stream);
}

extern "C" int ptt_earlier_agg_block_apply_f32(void* z, const void* r, const void* dofs, const void* dptr,
                                       const void* inv, const void* iptr, const void* work,
                                       int nitems, int max_k, int device, void* stream) {
  return launch_agg<float>(z, r, dofs, dptr, inv, iptr, work, nitems, max_k, device, stream);
}
