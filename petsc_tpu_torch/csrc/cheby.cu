// C1: the fused tail of one Chebyshev smoothing step, f64 and f32.
//
// Replaces the XLA-fused elementwise tail of each step of
// petsc_tpu/ksp/cheby.py: cheby_smooth :40-44 (first kind) and
// cheby_smooth4 :73-78 (fourth kind). After the SpMV w = A p (S2, or A x
// for the first step), one pass computes, with the Jacobi inverse
// diagonal dinv as a vector,
//   mode first:  r = b - w;  p = c (dinv r);        x += beta p
//   mode step:   r -= w;     p = a p + c (dinv r);  x += beta p
// and overwrites r, p and x in place: the smoother owns those buffers.
// With a smoothing PC other than Jacobi (the aggregate-block smoother of
// -pc_gamg_asm_use_agg, kernel A1) the caller forms r and z = M^-1 r first,
// and the z modes finish the step with z in place of dinv r:
//   mode first_z:  p = c z;        x += beta p
//   mode step_z:   p = a p + c z;  x += beta p
// leaving r alone. The smoother takes them only for a PC without a fused
// step: A1 finishes the step itself at its stores (agg_block.cu's
// epilogue), and writes no z.
// The first kind takes beta = 1 and (first) c = 1/theta, (step) a = rho_n
// rho, c = 2 rho_n / delta; the fourth kind (first) c = 4/(3 rho) and
// (step) a = (2k-3)/(2k+1), c = (8k-4)/((2k+1) rho), beta = 1 or its
// optimized beta_k; a Richardson sweep with Jacobi is mode first with
// c = beta = 1.
//
// Bound: device-memory bandwidth. Mode step reads five vectors and writes
// three (8 n itemsize bytes: 134.2 MB, 0.0401 ms at 3.35 TB/s for f64 at
// 128^3); mode first reads four and writes three (7/8 of that), for about
// 5 flops per element.
// Design for that bound: K2's (triad.cu): one tile of kThreads 16-byte
// packs per block and as many blocks as tiles, so each thread issues all
// its loads at once, computes, stores one pack of each output and exits,
// and the block scheduler keeps every SM full of fresh loads. When every
// pointer is off 16 bytes by the same amount a scalar head up to the first
// 16-byte edge is peeled; the tail past the last pack is scalar; mixed
// alignment takes scalar loads throughout. The scalars arrive by value
// (they are host numbers in the smoother) and are rounded to T, as the
// plain PyTorch version rounds a Python scalar. Each element is read and
// written by one thread, which loads before it stores.
#include "common.cuh"

namespace {

constexpr long long kMaxGrid = 1LL << 30;

template <bool kFirst, typename T>
__device__ __forceinline__ void step1(T& r, T& p, T& x, T b, T w, T d, T a, T c, T beta) {
  if constexpr (kFirst) {
    r = b - w;
    p = c * (d * r);
  } else {
    r = r - w;
    p = a * p + c * (d * r);
  }
  x = x + beta * p;
}

template <bool kFirst, typename T>
__device__ __forceinline__ void step1(ptt::Pack<T>& r, ptt::Pack<T>& p, ptt::Pack<T>& x,
                                      const ptt::Pack<T>& b, const ptt::Pack<T>& w,
                                      const ptt::Pack<T>& d, T a, T c, T beta) {
#pragma unroll
  for (int k = 0; k < ptt::Pack<T>::kWidth; ++k)
    step1<kFirst>(r.v[k], p.v[k], x.v[k], b.v[k], w.v[k], d.v[k], a, c, beta);
}

// item i of E (T or a pack of T): every load, then the update, then the stores
template <bool kFirst, typename T, typename E>
__device__ __forceinline__ void at(E* r, E* p, E* x, const E* b, const E* w, const E* d, T a,
                                   T c, T beta, long long i) {
  const E wv = w[i], dv = d[i];
  E xv = x[i], rv, pv, bv;
  if constexpr (kFirst) {
    bv = b[i];
  } else {
    rv = r[i];
    pv = p[i];
    bv = wv;   // not read in this mode
  }
  step1<kFirst>(rv, pv, xv, bv, wv, dv, a, c, beta);
  r[i] = rv;
  p[i] = pv;
  x[i] = xv;
}

// head >= 0: elements before the first 16-byte edge of every pointer;
// head < 0: mixed alignment.
template <bool kFirst, typename T>
__global__ void __launch_bounds__(ptt::kThreads)
cheby_update_kernel(T* r, T* p, T* x, const T* b, const T* w, const T* d, T a, T c, T beta,
                    long long n, long long head) {
  using P = ptt::Pack<T>;
  constexpr int W = P::kWidth;
  const long long step = (long long)gridDim.x * ptt::kThreads;
  if (head >= 0) {
    const long long nv = (n - head) / W;
    P* rp = reinterpret_cast<P*>(r + head);
    P* pp = reinterpret_cast<P*>(p + head);
    P* xp = reinterpret_cast<P*>(x + head);
    const P* bp = reinterpret_cast<const P*>(kFirst ? b + head : w + head);
    const P* wp = reinterpret_cast<const P*>(w + head);
    const P* dp = reinterpret_cast<const P*>(d + head);
    for (long long i = (long long)blockIdx.x * ptt::kThreads + threadIdx.x; i < nv; i += step)
      at<kFirst>(rp, pp, xp, bp, wp, dp, a, c, beta, i);
    // the scalar ends, in block 0: the head and the tail past the last pack
    const long long tail = head + nv * W;
    if (blockIdx.x == 0) {
      if (threadIdx.x < head) at<kFirst>(r, p, x, b, w, d, a, c, beta, (long long)threadIdx.x);
      if (tail + threadIdx.x < n) at<kFirst>(r, p, x, b, w, d, a, c, beta, tail + threadIdx.x);
    }
  } else {
    for (long long i = (long long)blockIdx.x * ptt::kThreads + threadIdx.x; i < n; i += step)
      at<kFirst>(r, p, x, b, w, d, a, c, beta, i);
  }
}

// The z modes: p and x updated from z, one element per thread and step
// (ptt::cheby_z_update, which A1's fused epilogue calls too).
template <bool kFirst, typename T>
__global__ void __launch_bounds__(ptt::kThreads)
cheby_update_z_kernel(T* p, T* x, const T* z, T a, T c, T beta, long long n) {
  const long long step = (long long)gridDim.x * ptt::kThreads;
  for (long long i = (long long)blockIdx.x * ptt::kThreads + threadIdx.x; i < n; i += step) {
    T pv = kFirst ? T(0) : p[i], xv = x[i];
    ptt::cheby_z_update<kFirst>(pv, xv, z[i], a, c, beta);
    x[i] = xv;
    p[i] = pv;
  }
}

// The shared head of `count` pointers (see ptt::aligned_head), or -1.
template <typename T>
long long common_head(long long n, const void* const* ptrs, int count) {
  const long long head = ptt::aligned_head<T>(n, ptrs[0], ptrs[0]);
  for (int k = 1; k < count; ++k)
    if (ptt::aligned_head<T>(n, ptrs[0], ptrs[k]) < 0) return -1;
  return head;
}

// mode 0: first (reads b), mode 1: step (b unused, may be null); modes 2
// and 3: first_z and step_z (d holds z; r and b unused)
template <typename T>
int launch_cheby(int mode, void* r, void* p, void* x, const void* b, const void* w,
                 const void* d, double a, double c, double beta, long long n, int device,
                 void* stream) {
  PTT_TRY(cudaSetDevice(device));
  constexpr long long kPerBlock = (long long)ptt::Pack<T>::kWidth * ptt::kThreads;
  long long grid = (n + kPerBlock - 1) / kPerBlock;
  grid = grid < 1 ? 1 : grid > kMaxGrid ? kMaxGrid : grid;
  if (mode >= 2) {
    const int zgrid = ptt::grid_for(n, device, kMaxGrid);
    if (mode == 2)
      cheby_update_z_kernel<true, T><<<zgrid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
          (T*)p, (T*)x, (const T*)d, (T)a, (T)c, (T)beta, n);
    else
      cheby_update_z_kernel<false, T><<<zgrid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
          (T*)p, (T*)x, (const T*)d, (T)a, (T)c, (T)beta, n);
    return (int)cudaGetLastError();
  }
  const void* ptrs[6] = {r, p, x, w, d, b};
  const long long head = common_head<T>(n, ptrs, mode == 0 ? 6 : 5);
  if (mode == 0)
    cheby_update_kernel<true, T><<<(unsigned int)grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
        (T*)r, (T*)p, (T*)x, (const T*)b, (const T*)w, (const T*)d, (T)a, (T)c, (T)beta, n, head);
  else
    cheby_update_kernel<false, T><<<(unsigned int)grid, ptt::kThreads, 0, (cudaStream_t)stream>>>(
        (T*)r, (T*)p, (T*)x, (const T*)w, (const T*)w, (const T*)d, (T)a, (T)c, (T)beta, n, head);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_cheby_update_f64(int mode, void* r, void* p, void* x, const void* b,
                                    const void* w, const void* d, double a, double c,
                                    double beta, long long n, int device, void* stream) {
  return launch_cheby<double>(mode, r, p, x, b, w, d, a, c, beta, n, device, stream);
}

extern "C" int ptt_cheby_update_f32(int mode, void* r, void* p, void* x, const void* b,
                                    const void* w, const void* d, double a, double c,
                                    double beta, long long n, int device, void* stream) {
  return launch_cheby<float>(mode, r, p, x, b, w, d, a, c, beta, n, device, stream);
}
